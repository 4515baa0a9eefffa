"""Port: the warm-up walk (slam/prewarm.py), after tests/test_prewarm.py.

* the walk completes at small rungs (both step forms, the mirror's splice
  and scatter, triangulation, the indexed fuse, the segmented and the whole
  local BA, the classic fallbacks, loop closing) with no exception, sets
  core_ready and installs the shared tracker, and leaves the live device
  mirror, torch's global RNG and numpy's global RNG as they were;
* a 6-frame System with prewarm (the walk running beside tracking) tracks
  exactly as the System without it: the trajectories equal bit for bit.
"""

import numpy as np
import pytest
import torch

import synth_world
from iv_slam_tpu_torch import config as tconfig
from iv_slam_tpu_torch.slam import prewarm
from iv_slam_tpu_torch.slam.system import System
from iv_slam_tpu_torch.slam.tracking import Tracking
from iv_slam_tpu_torch.solvers.local_ba import LBA_RUNGS
from torch_parity import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

SMALL = dict(live_rungs=[1024], fuse_shapes=[(16, 1024)], ba_rungs=[LBA_RUNGS[0]])


def make_config(**system):
    cfg = tconfig.Config()
    cfg.camera = tconfig.CameraConfig(fx=400.0, fy=400.0, cx=160.0, cy=120.0, bf=200.0,
                                      width=320, height=240, th_depth=35.0, fps=10.0)
    cfg.orb = tconfig.ORBConfig(n_features=800, n_levels=4)
    cfg.system.fused_tracking = True
    for k, v in system.items():
        setattr(cfg.system, k, v)
    return cfg


@pytest.mark.parametrize("threaded", [False, True])
def test_prewarm_walk_completes(monkeypatch, threaded):
    # the global BA's first rung is ~30 s of dense Schur solve on one CPU
    # thread: walk the local BA's first rung in its place
    from iv_slam_tpu_torch.solvers import local_ba

    monkeypatch.setattr(local_ba, "GBA_RUNGS", (LBA_RUNGS[0],))
    cfg = make_config(threaded_local_mapping=threaded, enable_loop_closing=threaded)
    tr = Tracking(cfg, 240, 320, device="cpu")
    torch_rng, np_rng = torch.get_rng_state(), np.random.get_state()
    t = prewarm.prewarm_async(tr, **SMALL)
    t.join(timeout=900)
    assert not t.is_alive() and t.core_ready.is_set()
    assert t.exc is None, t.exc
    # the shared tracker and mirror are installed for the tracking loop; the
    # walk used a mirror of its own
    assert tr._fused is not None and tr.local_mapping.dmap is tr._dmap
    assert tr._dmap.live_cap == 1024 and not bool(tr._dmap.valid.any())
    assert torch.equal(torch.get_rng_state(), torch_rng)
    after = np.random.get_state()
    assert after[0] == np_rng[0] and np.array_equal(after[1], np_rng[1])
    assert after[2:] == np_rng[2:]
    tr.local_mapping.stop_worker()


def test_prewarm_failure_raises_at_join(monkeypatch):
    """A failed walk is not hidden: System's join raises it."""
    def broken(*a, **kw):
        raise RuntimeError("warm step failed")

    monkeypatch.setattr(prewarm, "_warm_triangulate", broken)
    walk = prewarm.prewarm_async
    monkeypatch.setattr(prewarm, "prewarm_async", lambda tr: walk(tr, **SMALL))
    s = System(make_config(prewarm=True), 240, 320, device="cpu")
    with pytest.raises(RuntimeError, match="prewarm walk failed"):
        s.trajectory_twc()
    assert isinstance(s._prewarm_thread.exc, RuntimeError)


def test_system_with_prewarm_tracks_identically(monkeypatch):
    walk = prewarm.prewarm_async
    monkeypatch.setattr(prewarm, "prewarm_async", lambda tr: walk(tr, **SMALL))
    world, frames, gt = synth_world.make_sequence(np.random.default_rng(5), n_frames=6,
                                                  step=0.08)

    def run(on):
        s = System(make_config(prewarm=on), 240, 320, device="cpu")
        assert (s._prewarm_thread is not None) == on
        for i, (left, right) in enumerate(frames):
            s.track_stereo(left, right, timestamp=i * 0.1)
        est = np.stack(s.trajectory_twc())
        s.shutdown()
        return est, s.tracking.map.n_points

    est_on, n_on = run(True)
    est_off, n_off = run(False)
    assert n_on == n_off
    np.testing.assert_array_equal(est_on, est_off)
