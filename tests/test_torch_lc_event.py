"""Port: LoopClosing.process_keyframe on a map recorded from the JAX
package's System, at the keyframe event where that System closes its
first loop (the System-level loop-closing case: no world short enough for
the tier-1 budget lets both Systems run to a closed loop).

The JAX System (no-FMA subprocess, tests/torch_parity.py::_task_lc_event)
runs bench.py's loop-closing world on a 4 m circle, 40 frames, fused,
use_bow and loop closing on, a keyframe forced every second frame, 3
pyramid levels, local BA at every fourth frame's event, with a vocabulary
the port trained on the world's own descriptors; it closes its first loop
at frame 37. Its map, saved just before that call, is loaded into the
port's MapStore, the loop-closing state restored (keyframe database in
insertion order, consistent groups, loop edges), and the port's
process_keyframe runs with JAX's Sim3 hypothesis indices: the same
loop-closing state after, the same loop fuse, the same live points,
observations and associations; poses and points within 1e-3 (3.3e-4
seen: the essential graph's 20 LM iterations over 21 keyframes sum H in
float64 rounded once here and in float32 by XLA's scatter-add there, and
its accepted steps compound the difference). The global BA is left out
on both sides (tests/test_torch_loop_closing.py holds it): at this map's
size its 40 iterations take minutes on the CPU path.
"""

import numpy as np
import pytest

from iv_slam_tpu_torch import config as tconfig
from iv_slam_tpu_torch.slam import loop_closing as tlc
from iv_slam_tpu_torch.slam.frame import StereoFrontend
from iv_slam_tpu_torch.slam.keyframe_db import KeyFrameDatabase
from iv_slam_tpu_torch.slam.map_store import MapStore
from iv_slam_tpu_torch.slam.vocabulary import Vocabulary
from torch_parity import (dump_map, jax_sim3_indices, lc_state, lc_world,  # noqa: F401
                          one_thread, run_reference, vocabulary_arrays)

pytestmark = pytest.mark.usefixtures("one_thread")

LC_EVENT = dict(n_frames=40, radius=4.0, kf_every=2, n_levels=3, ba_rate=4)


def test_process_keyframe_on_recorded_jax_map(tmp_path, monkeypatch):
    cfg = tconfig.Config()
    cfg.camera = tconfig.CameraConfig(fx=400.0, fy=400.0, cx=160.0, cy=120.0, bf=200.0,
                                      width=320, height=240, fps=10.0)
    cfg.orb = tconfig.ORBConfig(n_features=800, n_levels=LC_EVENT["n_levels"])
    pairs, _gt = lc_world(LC_EVENT["n_frames"], LC_EVENT["radius"])
    fe = StereoFrontend(cfg, 240, 320, device="cpu")
    descs = []
    for left, right in pairs[::3]:
        fr = fe.process(left, right, 0.0)
        descs.append(fr.desc[fr.valid])
    voc = Vocabulary.train(np.concatenate(descs), k=10, L=4, seed=0)
    path = tmp_path / "before.npz"
    ref = run_reference("lc_event", tmp_path, timeout=900.0, map_path=str(path), **LC_EVENT,
                        **vocabulary_arrays(voc))
    m = MapStore.load(str(path), n_levels=LC_EVENT["n_levels"], scale_factor=1.2)
    lc = tlc.LoopClosing(cfg, m, voc, KeyFrameDatabase(voc), "cpu")
    lc.sampler = jax_sim3_indices
    for kf in ref["before_kfdb"].tolist():
        lc.bow.ensure(kf)
        lc.kfdb.add(kf, lc.bow.kf_bow[kf])
    members = iter(ref["before_group_members"].tolist())
    lc.consistent_groups = [({next(members) for _ in range(n)}, c) for n, c in
                            zip(ref["before_group_sizes"].tolist(),
                                ref["before_group_counts"].tolist())]
    lc.last_loop_kf = int(ref["before_last_loop_kf"])
    lc.loop_edges = {tuple(e) for e in ref["before_loop_edges"].tolist()}
    lc.n_loops_closed = int(ref["before_n_loops"])
    assert lc_state(lc)["kfdb"].tolist() == ref["before_kfdb"].tolist()
    monkeypatch.setattr(tlc, "global_bundle_adjustment_async", lambda *a, **k: None)
    assert lc.process_keyframe(int(ref["kf_id"]), fix_scale=True)
    for k, v in lc_state(lc).items():
        np.testing.assert_array_equal(v, ref["after_" + k], err_msg=k)
    assert int(ref["after_n_loops"]) == 1
    st = lc.last_fuse_stats
    np.testing.assert_array_equal([st[k] for k in ("targets", "loop_pts", "replaced", "added")],
                                  ref["fuse"])
    got = dump_map(m)
    want = {k[len("map_"):]: v for k, v in ref.items() if k.startswith("map_")}
    for k in ("pt_alive", "obs", "kf_alive", "fr_map_pt", "pt_ref_kf", "pt_n_obs", "pt_desc"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["kf_pose"], want["kf_pose"], rtol=0, atol=1e-3)
    alive = want["pt_alive"]
    np.testing.assert_allclose(got["pt_pos"][alive], want["pt_pos"][alive], rtol=0, atol=1e-3)
    assert int(ref["frame"]) == 37
