"""Port parity: one LocalMapping keyframe event (slam/local_mapping.py
``_process_one``: point culling, triangulation, fuse, local BA, keyframe
culling) against the JAX package's.

The JAX package's System tracks a tests/synth_world.py sequence at 240x320
with a keyframe forced every third frame (tests/test_ba_variants.py's
loop), in the no-FMA subprocess (tests/torch_parity.py); its map just
before and just after one keyframe event comes back. The port rebuilds the
same MapStore (points, observation dicts in insertion order, keyframes and
their frames, the recent-points list) and runs the same event, with the
fuse's candidate tables uploaded (the classic configuration's path) and
gathered from a synced DeviceMap (the fused configuration's).

Exact: which points exist, are alive and observed by which keyframe
feature, in which dict order; which keyframes are alive; every frame's
map_pt. Within stated tolerances, after the local BA: keyframe poses 1e-5
(3.4e-6 seen) and point positions 1e-4 m (2.1e-5 seen), their normals and
scale ranges 1e-5 relative.

The vis local BA (``ba_mode="vis"``) runs once on the map after that event
at the same keyframe, with every keyframe's keypoints moved by 1.5 px of
seeded noise, so that its residuals reach the chi-square window: which points it updates and
which observations it erases exact, each point's quality within 1e-3 (its
summed chi2 carries the BA's small differences through the quantile
window's slope), keyframe poses and point positions within 1e-4 and 2e-4 m
(the noisy problem is less well conditioned than the clean one; points
sit ~10 m away, and 1.1e-4 m, 1.1e-5 relative, was seen).

The constrained local BA (``ba_mode="constrained"``, IV-SLAM's guided BA
of training-data generation) runs once more on that noisy map at the same
keyframe, every keyframe given its ground-truth pose relative to the first
camera: the window's keyframes pinned to it exactly (the same numpy
inverse), no observation erased, which keypoints get a quality label exact,
the labels within 1e-3 (a label is 2/(1 + (chi2 - 1)/6.815) - 1 of an
edge's final chi2, which carries the BA's small differences) and point
positions within 5e-4 m (2.3e-4 m, 2.2e-5 relative, seen on one point of
2,373: with every pose fixed each point is its own small LM, and a weakly
observed one ends its iterations further apart).
"""

import numpy as np
import pytest
import torch

from iv_slam_tpu_torch.ops.extractor import Keypoints
from iv_slam_tpu_torch.slam.device_map import DeviceMap
from iv_slam_tpu_torch.slam.frame import Frame
from iv_slam_tpu_torch.slam.local_mapping import LocalMapping
from iv_slam_tpu_torch.slam.map_store import MapStore
from iv_slam_tpu_torch.solvers import local_ba
from test_torch_fused_track import port_config
from torch_parity import dump_map, one_thread, run_reference  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

CAM = (400.0, 400.0, 160.0, 120.0, 200.0, 320, 240)
EVENT = 3   # the third forced keyframe's event: a 4-keyframe map, BA on


def build_map(d, n_levels):
    """A port MapStore equal to the dumped one."""
    m = MapStore(n_levels=n_levels, scale_factor=1.2)
    n, k = len(d["pt_pos"]), len(d["kf_pose"])
    m.n_points, m.n_keyframes = n, k
    for f in ("pt_pos", "pt_desc", "pt_normal", "pt_min_dist", "pt_max_dist", "pt_alive",
              "pt_quality", "pt_visible", "pt_found", "pt_first_kf", "pt_ref_kf",
              "pt_n_obs", "kf_pose", "kf_alive", "kf_frame_id", "kf_timestamp"):
        getattr(m, f)[: len(d[f])] = d[f]
    m.origin_kf = int(d["origin_kf"])
    for p, kf, feat in d["obs"]:
        m.pt_obs[int(p)][int(kf)] = int(feat)
    for i in range(k):
        t = lambda f: torch.from_numpy(np.ascontiguousarray(d["fr_" + f][i]))  # noqa: E731
        kp = Keypoints(xy=t("xy"), response=torch.zeros(len(d["fr_xy"][i])),
                       octave=t("octave"), angle=t("angle"), desc=t("desc"),
                       valid=t("valid"), yx_level=torch.zeros((len(d["fr_xy"][i]), 2),
                                                              dtype=torch.int32))
        fr = Frame(frame_id=int(d["kf_frame_id"][i]), timestamp=float(d["kf_timestamp"][i]),
                   kp=kp, u_right=d["fr_u_right"][i].copy(), depth=d["fr_depth"][i].copy(),
                   qual_score=d["fr_qual_score"][i].copy(), pose=d["kf_pose"][i].copy(),
                   map_pt=d["fr_map_pt"][i].copy())
        m.kf_frames[i] = fr
    return m


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference("keyframe_event", tmp_path_factory.mktemp("kfev"), seed=7,
                         n_frames=15, event=EVENT, kf_every=3, cam=np.array(CAM),
                         n_features=800, n_levels=4, vis_ba_px=1.5, constrained=True)


def _split(ref, pre):
    return {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}


@pytest.fixture(scope="module")
def event(reference):
    return (_split(reference, "before_"), _split(reference, "after_"),
            int(reference["kf_id"]), bool(reference["run_ba"]))


@pytest.mark.parametrize("mirror", [False, True], ids=["uploaded tables", "device map"])
def test_keyframe_event_matches_jax(event, mirror):
    before, after, kf_id, run_ba = event
    cfg = port_config(CAM, 800, 4)
    m = build_map(before, 4)
    assert dump_map(m)["obs"].tolist() == before["obs"].tolist()
    lm = LocalMapping(cfg, m, "cpu")
    lm.recent_points = {int(p): int(k) for p, k in before["recent"]}
    if mirror:
        lm.dmap = DeviceMap(device="cpu")
        lm.dmap.sync(m)
    lm._process_one(kf_id, run_ba)
    got = dump_map(m, lm.recent_points)

    n0 = len(before["pt_pos"])
    created = len(after["pt_pos"]) - n0
    killed = int(before["pt_alive"].sum() + created - after["pt_alive"].sum())
    assert run_ba and m.n_keyframes >= 4 and created > 20 and killed > 0, (created, killed)
    assert lm.ba_rungs == [(32, 2048, 4096)] and lm.overflows == {"triangulate": 0,
                                                                  "fuse": 0}
    for f in ("pt_alive", "pt_first_kf", "pt_ref_kf", "pt_n_obs", "pt_desc", "pt_visible",
              "pt_found", "kf_alive", "fr_map_pt", "recent"):
        np.testing.assert_array_equal(got[f], after[f], err_msg=f)
    assert got["obs"].tolist() == after["obs"].tolist()   # dict order included
    np.testing.assert_allclose(got["kf_pose"], after["kf_pose"], rtol=0, atol=1e-5)
    alive = after["pt_alive"]
    np.testing.assert_allclose(got["pt_pos"][alive], after["pt_pos"][alive], rtol=0,
                               atol=1e-4)
    for f in ("pt_normal", "pt_min_dist", "pt_max_dist"):
        np.testing.assert_allclose(got[f][alive], after[f][alive], rtol=1e-5, atol=1e-6,
                                   err_msg=f)


@pytest.fixture(scope="module")
def vis_event(reference):
    return (_split(reference, "vis_before_"), _split(reference, "vis_after_"),
            int(reference["kf_id"]))


def test_vis_local_ba_matches_jax(vis_event):
    before, after, kf_id = vis_event
    cfg = port_config(CAM, 800, 4)
    cfg.iv.ba_mode = "vis"
    m = build_map(before, 4)
    LocalMapping(cfg, m, "cpu")          # the vis mode is accepted
    assert local_ba.local_bundle_adjustment_vis(cfg, m, kf_id, "cpu") == (32, 2048, 4096)
    got = dump_map(m)
    want_upd = np.nonzero(after["pt_quality"] != before["pt_quality"])[0]
    got_upd = np.nonzero(got["pt_quality"] != before["pt_quality"])[0]
    assert len(want_upd) > 50, len(want_upd)
    np.testing.assert_array_equal(got_upd, want_upd)
    assert got["obs"].tolist() == after["obs"].tolist()
    np.testing.assert_array_equal(got["fr_map_pt"], after["fr_map_pt"])
    np.testing.assert_allclose(got["pt_quality"], after["pt_quality"], rtol=0, atol=1e-3)
    assert (after["pt_quality"] < 0.5).sum() > 10     # the window's far side is reached
    dq = np.abs(got["pt_quality"] - after["pt_quality"])
    print(f"vis BA: {len(want_upd)} points updated, quality max |diff| {dq.max():.3g}")
    np.testing.assert_allclose(got["kf_pose"], after["kf_pose"], rtol=0, atol=1e-4)
    alive = after["pt_alive"]
    np.testing.assert_allclose(got["pt_pos"][alive], after["pt_pos"][alive], rtol=0, atol=2e-4)


def test_constrained_local_ba_matches_jax(reference):
    before, after = _split(reference, "con_before_"), _split(reference, "con_after_")
    kf_id = int(reference["kf_id"])
    cfg = port_config(CAM, 800, 4)
    cfg.iv.ba_mode = "constrained"
    m = build_map(before, 4)
    for k, T in enumerate(reference["con_gt_pose"]):
        m.kf_gt_pose[k] = T
    LocalMapping(cfg, m, "cpu")          # the constrained mode is accepted
    assert local_ba.constrained_local_bundle_adjustment(cfg, m, kf_id, "cpu") == (32, 2048, 4096)
    got = dump_map(m)
    np.testing.assert_array_equal(got["kf_pose"], after["kf_pose"])
    moved = np.abs(after["kf_pose"] - before["kf_pose"]).max(axis=(1, 2)) > 0
    assert moved.sum() >= 3
    assert got["obs"].tolist() == after["obs"].tolist() == before["obs"].tolist()
    np.testing.assert_array_equal(got["fr_map_pt"], after["fr_map_pt"])
    want_lab = after["fr_qual_score"] != before["fr_qual_score"]
    np.testing.assert_array_equal(got["fr_qual_score"] != before["fr_qual_score"], want_lab)
    assert want_lab.sum() > 100, want_lab.sum()
    np.testing.assert_allclose(got["fr_qual_score"], after["fr_qual_score"], rtol=0, atol=1e-3)
    assert (after["fr_qual_score"][want_lab] < 0.5).sum() > 10  # the window's far side
    alive = after["pt_alive"]
    np.testing.assert_allclose(got["pt_pos"][alive], after["pt_pos"][alive], rtol=0, atol=5e-4)
