"""Port: the measured-link adaptation (utils/linkprobe.py,
LocalMapping.set_link_profile, System's probe), after
tests/test_link_adaptive.py.

* the profile selection, against the JAX package's LocalMapping: a high
  RTT selects the monolithic family (64-target fuse, 16-neighbour
  triangulation, unsegmented async BA), a low one the chunked family; the
  IVT_* environment overrides win;
* the probe: a pinned value is returned, a measured one on the CPU is
  below the threshold, and System's selection follows link_rtt_ms;
* the two families estimate identically (the reference's slow test, cut to
  10 frames with each worker event waited for): bench.py's threading and
  chained tracking at link_rtt_ms 0 and 100, the chunked family cut to 2
  targets and 2 neighbours a call so that its events split where the
  monolithic family's do not: every forward fuse of the monolithic run
  takes all of its event's targets in one 64-target call, no frame is
  lost, and the trajectories agree within 1e-3 m.
"""

import numpy as np
import pytest

import synth_world
from iv_slam_tpu.slam.local_mapping import LocalMapping as JLocalMapping
from iv_slam_tpu_torch import config as tconfig
from iv_slam_tpu_torch.slam.local_mapping import LocalMapping
from iv_slam_tpu_torch.slam.map_store import MapStore
from iv_slam_tpu_torch.slam.system import System
from iv_slam_tpu_torch.utils import linkprobe
from torch_parity import one_thread, serialize_worker  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

H, W = 240, 320


@pytest.fixture(autouse=True)
def forget_pin():
    """A pinned RTT is process-wide: forget it after each test."""
    yield
    linkprobe.set_rtt_ms(None)


def make_config(rtt_ms):
    cfg = tconfig.Config()
    cfg.camera = tconfig.CameraConfig(fx=400., fy=400., cx=160., cy=120., bf=200.,
                                      width=W, height=H, th_depth=35., fps=10.)
    cfg.orb = tconfig.ORBConfig(n_features=800, n_levels=8)
    cfg.system.fused_tracking = True
    cfg.system.threaded_local_mapping = True
    cfg.system.async_local_ba = True
    cfg.system.chained_tracking = True
    cfg.system.link_rtt_ms = rtt_ms
    return cfg


def _profile(lm):
    return lm.fuse_chunk, lm.tri_chunk, lm.monolithic_device


def test_link_profile_selection(monkeypatch):
    cfg = make_config(None)
    m = MapStore(n_levels=cfg.orb.n_levels, scale_factor=cfg.orb.scale_factor)
    lm = LocalMapping(cfg, m, device="cpu")
    jlm = JLocalMapping(cfg, None)
    assert LocalMapping.FUSE_CHUNK == JLocalMapping.FUSE_CHUNK == 16
    assert LocalMapping.TRI_CHUNK == JLocalMapping.TRI_CHUNK == 8
    assert _profile(lm) == _profile(jlm) == (16, 8, False)
    for high in (True, False):
        lm.set_link_profile(high_rtt=high)
        jlm.set_link_profile(high_rtt=high)
        assert _profile(lm) == _profile(jlm) == ((64, 16, True) if high else (16, 8, False))
    monkeypatch.setenv("IVT_FUSE_CHUNK", "32")
    lm.set_link_profile(high_rtt=True)
    jlm.set_link_profile(high_rtt=True)
    assert _profile(lm) == _profile(jlm) == (LocalMapping.FUSE_CHUNK, 16, True)


def test_probe_pinning():
    linkprobe.set_rtt_ms(99.0)
    assert linkprobe.probe_rtt_ms() == 99.0
    linkprobe.set_rtt_ms(None)
    # a real probe on the CPU measures well under the threshold
    assert linkprobe.probe_rtt_ms(force=True, device="cpu") < 12.0
    for rtt, mono in ((0.0, False), (100.0, True), (None, False)):
        cfg = make_config(rtt)
        cfg.system.threaded_local_mapping = cfg.system.async_local_ba = False
        s = System(cfg, H, W, device="cpu")
        assert (s.link_rtt_ms == rtt) if rtt is not None else s.link_rtt_ms < 12.0
        assert s.tracking.local_mapping.monolithic_device == mono
        s.shutdown()
        linkprobe.set_rtt_ms(None)


def test_profiles_estimate_identically(monkeypatch):
    monkeypatch.setattr(LocalMapping, "FUSE_CHUNK", 2)
    monkeypatch.setattr(LocalMapping, "TRI_CHUNK", 2)
    world, frames, gt = synth_world.make_sequence(np.random.default_rng(7), n_frames=10,
                                                  step=0.12)

    def run(rtt):
        s = System(make_config(rtt), H, W, device="cpu")
        tr = s.tracking
        serialize_worker(tr.local_mapping)
        lm = tr.local_mapping
        calls, fuse_args = [], lm._fuse_args

        def counted(targets, pts, fwd_p_cap=None):
            if fwd_p_cap is not None:
                calls.append(len(targets))
            return fuse_args(targets, pts, fwd_p_cap)

        lm._fuse_args = counted
        for i, (left, right) in enumerate(frames):
            s.track_stereo(left, right, timestamp=i * 0.1)
            if i % 3 == 2 and tr.current.frame_id != tr.last_kf_frame_id:
                tr._create_new_keyframe()
        est = s.trajectory_twc()
        out = (np.stack([T[:3, 3] for T in est]), _profile(lm), s.failure_count,
               sum(tr.lost_flags), calls)
        s.shutdown()
        linkprobe.set_rtt_ms(None)
        return out

    t_chunk, prof_c, f_c, lost_c, calls_c = run(0.0)
    t_mono, prof_m, f_m, lost_m, calls_m = run(100.0)
    assert prof_c == (2, 2, False) and prof_m == (64, 16, True)
    assert f_c == f_m == 0 and lost_c == lost_m == 0
    assert len(t_chunk) == len(t_mono) == len(frames)
    # the monolithic run fuses each event's targets in one call; the
    # chunked run splits the same targets
    assert max(calls_m) > 2 and sum(calls_c) == sum(calls_m) and len(calls_c) > len(calls_m)
    np.testing.assert_allclose(t_chunk, t_mono, rtol=0, atol=1e-3)
