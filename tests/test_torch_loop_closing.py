"""Port: loop closing (slam/loop_closing.py) and the global BA
(solvers/local_ba.py) against the JAX package's, on tests/test_loop_closing.py's
manufactured scenarios built identically for both packages.

* _compute_sim3 on the unrecognized revisit (two keyframes over the same
  landmarks with disjoint point sets), the Sim3 RANSAC scored on JAX's
  hypothesis indices: the same loop keyframe, the same verified matches,
  S_rel within 1e-4;
* _detect_loop's 3-detection consistency: the same candidates after each
  of four detections;
* _search_and_fuse: the same points replaced, the same observations;
* the essential graph on a drifted 12-keyframe chain: poses and the
  anchored points within 1e-5 of JAX's; the Sim3 propagation with a
  yaw-differing neighbour, stereo and mono (fix_scale=False): poses and
  points within 1e-5;
* _correct_loop end to end on the revisit (propagation, loop fusion,
  essential graph, deferred global BA merged by collect_gba): the same
  live points and observations, poses within 1e-4 and points within 1e-3
  (the 40-iteration global BA runs in float32 on both sides and its
  systems are solved in different orders);
* the global BA, blocking, and deferred with the map grown before the
  merge (test_async_gba_merge_back): poses within 1e-5, points within 1e-4.

tests/test_torch_lc_event.py holds process_keyframe on a map recorded
from the JAX System. Every test here runs both packages in this process
(their float decisions are far from the thresholds). The deferred global
BA is padded to a GBA_RUNGS table of one small rung on both sides: the
smallest production rung (8192 points) makes the port's dense Schur solve
take ~30 s on one CPU thread, for problems of 60-240 points.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from iv_slam_tpu.config import CameraConfig as JCameraConfig
from iv_slam_tpu.config import Config as JConfig
from iv_slam_tpu.config import ORBConfig as JORBConfig
from iv_slam_tpu.ops.extractor import Keypoints as JKeypoints
from iv_slam_tpu.slam.frame import Frame as JFrame
from iv_slam_tpu.slam.keyframe_db import KeyFrameDatabase as JKeyFrameDatabase
from iv_slam_tpu.slam.loop_closing import LoopClosing as JLoopClosing
from iv_slam_tpu.slam.map_store import MapStore as JMapStore
from iv_slam_tpu.slam.vocabulary import Vocabulary as JVocabulary
from iv_slam_tpu.solvers import local_ba as jlba
from iv_slam_tpu_torch import config as tconfig
from iv_slam_tpu_torch.ops.extractor import Keypoints as TKeypoints
from iv_slam_tpu_torch.slam.frame import Frame as TFrame
from iv_slam_tpu_torch.slam.keyframe_db import KeyFrameDatabase as TKeyFrameDatabase
from iv_slam_tpu_torch.slam.loop_closing import LoopClosing as TLoopClosing
from iv_slam_tpu_torch.slam.map_store import MapStore as TMapStore
from iv_slam_tpu_torch.slam.vocabulary import Vocabulary as TVocabulary
from iv_slam_tpu_torch.solvers import local_ba as tlba
from torch_parity import dump_map, jax_sim3_indices, one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

SMALL_GBA_RUNGS = ((64, 512, 1024),)


@pytest.fixture
def small_gba_rungs(monkeypatch):
    monkeypatch.setattr(jlba, "GBA_RUNGS", SMALL_GBA_RUNGS)
    monkeypatch.setattr(tlba, "GBA_RUNGS", SMALL_GBA_RUNGS)

PKG = {
    "jax": dict(Config=JConfig, CameraConfig=JCameraConfig, ORBConfig=JORBConfig,
                Keypoints=JKeypoints, Frame=JFrame, MapStore=JMapStore,
                KeyFrameDatabase=JKeyFrameDatabase, Vocabulary=JVocabulary,
                LoopClosing=JLoopClosing, arr=jnp.asarray),
    "torch": dict(Config=tconfig.Config, CameraConfig=tconfig.CameraConfig,
                  ORBConfig=tconfig.ORBConfig, Keypoints=TKeypoints, Frame=TFrame,
                  MapStore=TMapStore, KeyFrameDatabase=TKeyFrameDatabase,
                  Vocabulary=TVocabulary, LoopClosing=TLoopClosing, arr=torch.as_tensor),
}


def make_frame(P, fid, xy, desc, pose, n_cap=256):
    """tests/test_loop_closing.py::_make_frame for package P."""
    n = len(xy)
    pad = n_cap - n
    arr = P["arr"]
    valid = np.zeros(n_cap, bool)
    valid[:n] = True
    kp = P["Keypoints"](
        xy=arr(np.pad(xy.astype(np.float32), ((0, pad), (0, 0)))),
        response=arr(np.zeros(n_cap, np.float32)),
        octave=arr(np.zeros(n_cap, np.int32)),
        angle=arr(np.zeros(n_cap, np.float32)),
        desc=arr(np.pad(desc, ((0, pad), (0, 0)))),
        valid=arr(valid),
        yx_level=arr(np.zeros((n_cap, 2), np.int32)))
    return P["Frame"](frame_id=fid, timestamp=float(fid), kp=kp,
                      u_right=np.full(n_cap, -1.0, np.float32),
                      depth=np.full(n_cap, -1.0, np.float32),
                      qual_score=np.ones(n_cap, np.float32), pose=pose.astype(np.float32))


def make_config(P):
    cfg = P["Config"]()
    cfg.camera = P["CameraConfig"](fx=400, fy=400, cx=160, cy=120, bf=200, width=320,
                                   height=240)
    cfg.orb = P["ORBConfig"](n_features=256)
    return cfg


def make_lc(P, cfg, m, voc):
    kfdb = P["KeyFrameDatabase"](voc)
    if P is PKG["torch"]:
        lc = P["LoopClosing"](cfg, m, voc, kfdb, "cpu")
        lc.sampler = jax_sim3_indices
        return lc
    return P["LoopClosing"](cfg, m, voc, kfdb)


def ensure_bow(lc, kf):
    """The keyframe's BoW data: the port keeps it on the shared KeyFrameBow,
    the reference on LoopClosing. Returns its BowVector."""
    if hasattr(lc, "bow"):
        lc.bow.ensure(kf)
        return lc.bow.kf_bow[kf]
    lc._ensure_bow(kf)
    return lc.kf_bow[kf]


def revisit_scenario(P):
    """tests/test_loop_closing.py::_build_scenario: keyframe 0 at the origin
    and keyframe 1 revisiting with a slight offset, over the same 120
    landmarks registered as two disjoint point sets."""
    rng = np.random.default_rng(17)
    cfg = make_config(P)
    m = P["MapStore"](n_levels=8, scale_factor=1.2)
    n_pts = 120
    Xw = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
                   rng.uniform(6, 14, n_pts)], 1).astype(np.float32)
    descs = rng.integers(0, 256, (n_pts, 32)).astype(np.uint8)
    T1 = np.eye(4, dtype=np.float32)
    T1[:3, 3] = [0.1, 0.02, 0.05]
    frames = []
    for fid, T in ((0, np.eye(4, dtype=np.float32)), (1, T1)):
        pc = Xw @ T[:3, :3].T + T[:3, 3]
        uv = np.stack([400 * pc[:, 0] / pc[:, 2] + 160, 400 * pc[:, 1] / pc[:, 2] + 120], 1)
        frames.append(make_frame(P, fid, uv, descs, T))
    kfs = []
    for k, f in enumerate(frames):
        kf = m.add_keyframe(f)
        kfs.append(kf)
        for i in range(n_pts):
            pos = Xw[i] if k == 0 else Xw[i] + rng.normal(0, 0.01, 3).astype(np.float32)
            pid = m.add_point(pos, kf)
            m.add_observation(pid, kf, i)
            f.map_pt[i] = pid
            m.pt_desc[pid] = descs[i]
            m.update_normal_and_depth(pid)
    voc = P["Vocabulary"].train(descs, k=6, L=3, seed=3)
    return cfg, m, voc, kfs[0], kfs[1]


def assert_same_map(mt, mj, pose_atol, pos_atol):
    t, j = dump_map(mt), dump_map(mj)
    for k in ("pt_alive", "obs", "kf_alive", "fr_map_pt", "pt_ref_kf", "pt_n_obs", "pt_desc"):
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    np.testing.assert_allclose(t["kf_pose"], j["kf_pose"], rtol=0, atol=pose_atol)
    alive = j["pt_alive"]
    np.testing.assert_allclose(t["pt_pos"][alive], j["pt_pos"][alive], rtol=0, atol=pos_atol)


def test_compute_sim3_matches_jax():
    out = {}
    for name, P in PKG.items():
        cfg, m, voc, kf0, kf1 = revisit_scenario(P)
        lc = make_lc(P, cfg, m, voc)
        ensure_bow(lc, kf0)
        ensure_bow(lc, kf1)
        out[name] = lc._compute_sim3(kf1, [kf0], fix_scale=True)
    (lt, (St, st), mt), (lj, (Sj, sj), mj) = out["torch"], out["jax"]
    assert lt == lj == 0
    assert mt == mj and len(mt) >= 20
    np.testing.assert_allclose(St, Sj, rtol=0, atol=1e-4)
    assert abs(st - sj) < 1e-4 and abs(st - 1.0) < 0.05


def test_detect_loop_consistency_matches_jax():
    got = {}
    for name, P in PKG.items():
        cfg, m, voc, kf0, kf1 = revisit_scenario(P)
        lc = make_lc(P, cfg, m, voc)
        lc.kfdb.add(kf0, ensure_bow(lc, kf0))
        ensure_bow(lc, kf1)
        got[name] = [(lc._detect_loop(kf1), [(sorted(g), n) for g, n in lc.consistent_groups])
                     for _ in range(4)]
    assert got["torch"] == got["jax"]
    assert got["torch"][0][0] == [] and got["torch"][3][0] == [0]


def test_search_and_fuse_matches_jax():
    maps = {}
    for name, P in PKG.items():
        cfg, m, voc, kf0, kf1 = revisit_scenario(P)
        lc = make_lc(P, cfg, m, voc)
        lc._search_and_fuse([kf1], kf0)
        maps[name] = (m, lc.last_fuse_stats)
    (mt, st), (mj, sj) = maps["torch"], maps["jax"]
    assert_same_map(mt, mj, 0.0, 0.0)
    assert st["replaced"] == sj["replaced"] > 90 and st["added"] == sj["added"]


def chain_scenario(P, K=12, d=0.06):
    """tests/test_loop_closing.py::test_essential_graph_distributes_correction:
    a drifted chain whose last keyframe is snapped back, one landmark per
    keyframe."""
    cfg = make_config(P)
    m = P["MapStore"](n_levels=8, scale_factor=1.2)

    def tcw(center):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = -np.asarray(center, np.float32)
        return T

    for k in range(K):
        c = np.array([k, d * k, 0.0])
        f = make_frame(P, k, np.zeros((1, 2)), np.zeros((1, 32), np.uint8), tcw(c))
        kf = m.add_keyframe(f)
        pid = m.add_point((c + np.array([0, 0, 5.0])).astype(np.float32), kf)
        m.add_observation(pid, kf, 0)
    uncorrected = {K - 1: m.kf_pose[K - 1].copy()}
    m.set_kf_pose(K - 1, tcw([K - 1, 0.0, 0.0]))
    voc = P["Vocabulary"].train(np.random.default_rng(0).integers(0, 256, (40, 32))
                                .astype(np.uint8), k=4, L=2, seed=0)
    return cfg, m, voc, uncorrected


def test_essential_graph_matches_jax():
    maps = {}
    for name, P in PKG.items():
        cfg, m, voc, uncorrected = chain_scenario(P)
        lc = make_lc(P, cfg, m, voc)
        lc._run_essential_graph(11, 0, uncorrected, {}, {})
        maps[name] = (m, lc.loop_edges)
    (mt, et), (mj, ej) = maps["torch"], maps["jax"]
    assert et == ej == {(0, 11)}
    assert_same_map(mt, mj, 1e-5, 1e-5)
    c6 = -mt.kf_pose[6][:3, :3].T @ mt.kf_pose[6][:3, 3]
    assert np.linalg.norm(c6 - [6, 0, 0]) < 0.45 * 0.06 * 6


def _yaw(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def neighbourhood_scenario(P, yaw_nb):
    """tests/test_loop_closing.py::_lc_with_neighborhood: the loop keyframe,
    the current one and a yaw-differing covisible neighbour."""
    cfg = make_config(P)
    m = P["MapStore"](n_levels=8, scale_factor=1.2)
    rng = np.random.default_rng(5)
    descs = rng.integers(0, 256, (40, 32)).astype(np.uint8)
    T_cur = np.eye(4, dtype=np.float32)
    T_cur[:3, :3] = _yaw(0.1)
    T_cur[:3, 3] = [0.3, 0.0, 0.2]
    T_nb = np.eye(4, dtype=np.float32)
    T_nb[:3, :3] = _yaw(yaw_nb)
    T_nb[:3, 3] = [0.5, 0.1, -0.2]
    frames = [make_frame(P, i, np.zeros((40, 2)), descs, T)
              for i, T in enumerate((np.eye(4, dtype=np.float32), T_cur, T_nb))]
    for f in frames:
        m.add_keyframe(f)
    pts = rng.uniform(-2, 2, (20, 3)).astype(np.float32)
    pts[:, 2] += 8
    for i in range(20):
        pid = m.add_point(pts[i], 2)
        for kf in (1, 2):
            m.add_observation(pid, kf, i)
            frames[kf].map_pt[i] = pid
    voc = P["Vocabulary"].train(descs, k=4, L=2, seed=0)
    return make_lc(P, cfg, m, voc), m


@pytest.mark.parametrize("fix_scale", [True, False])
def test_propagate_correction_matches_jax(fix_scale):
    s = 1.0 if fix_scale else 1.5
    S_rel = np.eye(4, dtype=np.float32)
    S_rel[:3, :3] = s * _yaw(0.2)
    S_rel[:3, 3] = [0.6, 0.0, -0.3]
    out = {}
    for name, P in PKG.items():
        lc, m = neighbourhood_scenario(P, 0.5 if fix_scale else 0.3)
        out[name] = (m, lc._propagate_correction(1, 0, (S_rel, s), fix_scale=fix_scale))
    (mt, rt), (mj, rj) = out["torch"], out["jax"]
    assert_same_map(mt, mj, 1e-5, 1e-5)
    assert rt[0] == rj[0] and rt[3] == rj[3]
    for k in rj[1]:
        np.testing.assert_array_equal(rt[1][k], rj[1][k])
    for k, (R, tt, sk) in rj[2].items():
        np.testing.assert_allclose(rt[2][k][0], R, atol=1e-6)
        np.testing.assert_allclose(rt[2][k][1], tt, atol=1e-6)
        assert abs(rt[2][k][2] - sk) < 1e-9
    if not fix_scale:
        assert abs(rt[2][1][2] - s) < 1e-4


def test_correct_loop_matches_jax(small_gba_rungs):
    """The whole correction on the revisit: the verified matches fuse, the
    loop side's points fuse into the corrected neighbourhood, the essential
    graph runs, and the deferred global BA merges at collect_gba."""
    out = {}
    for name, P in PKG.items():
        cfg, m, voc, kf0, kf1 = revisit_scenario(P)
        lc = make_lc(P, cfg, m, voc)
        ensure_bow(lc, kf0)
        ensure_bow(lc, kf1)
        loop_kf, S_corr, matched = lc._compute_sim3(kf1, [kf0], fix_scale=True)
        lc._correct_loop(kf1, loop_kf, S_corr, matched, fix_scale=True)
        pending = lc.pending_gba is not None
        merged = lc.collect_gba()
        out[name] = (m, pending, merged, lc.loop_edges)
    (mt, pt, gt, et), (mj, pj, gj, ej) = out["torch"], out["jax"]
    assert pt == pj and gt == gj and et == ej
    assert_same_map(mt, mj, 1e-4, 1e-3)
    assert mt.pt_alive[:mt.n_points].sum() < 200       # the duplicates fused


def gba_map(P):
    """tests/test_loop_closing.py::test_async_gba_merge_back's drifted
    6-keyframe chain over 60 shared stereo landmarks."""
    m = P["MapStore"](n_levels=8, scale_factor=1.2)
    rng = np.random.default_rng(9)
    n_pts = 60
    Xw = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
                   rng.uniform(8, 14, n_pts)], 1).astype(np.float32)
    descs = rng.integers(0, 256, (n_pts, 32)).astype(np.uint8)

    def tcw(x, drift):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [-(x + drift), 0, 0]
        return T

    for k in range(6):
        T_true = tcw(0.3 * k, 0.0)
        pc = Xw @ T_true[:3, :3].T + T_true[:3, 3]
        uv = np.stack([400 * pc[:, 0] / pc[:, 2] + 160, 400 * pc[:, 1] / pc[:, 2] + 120], 1)
        f = make_frame(P, k, uv, descs, tcw(0.3 * k, 0.05 * k))
        f.u_right[:n_pts] = uv[:, 0] - 200.0 / pc[:, 2]
        kf = m.add_keyframe(f)
        for i in range(n_pts):
            pid = m.add_point(Xw[i], kf) if k == 0 else i
            m.add_observation(pid, kf, i)
            f.map_pt[i] = pid
    return m, Xw, tcw


def grow(P, m, Xw, tcw):
    """A 7th keyframe and 20 fresh points, as tracking adds while a
    deferred global BA is pending."""
    rng = np.random.default_rng(3)
    descs = rng.integers(0, 256, (20, 32)).astype(np.uint8)
    f7 = make_frame(P, 6, np.zeros((20, 2)), descs, tcw(0.3 * 6, 0.05 * 6))
    kf7 = m.add_keyframe(f7)
    for i in range(20):
        pid = m.add_point((Xw[i] + [0.0, 0.0, 0.5]).astype(np.float32), kf7)
        m.add_observation(pid, kf7, i)
        m.add_observation(pid, 5, i + 20)
        f7.map_pt[i] = pid
        m.kf_frames[5].map_pt[i + 20] = pid


@pytest.mark.parametrize("deferred", [False, True])
def test_global_ba_matches_jax(deferred, small_gba_rungs):
    cfg = make_config(PKG["torch"])
    maps = {}
    for name, P in PKG.items():
        m, Xw, tcw = gba_map(P)
        if not deferred:
            if name == "jax":
                jlba.global_bundle_adjustment(make_config(P), m, n_iters=20)
            else:
                tlba.global_bundle_adjustment(cfg, m, "cpu", n_iters=20)
        else:
            if name == "jax":
                h = jlba.global_bundle_adjustment_async(make_config(P), m, n_iters=20)
                grow(P, m, Xw, tcw)
                jlba.apply_global_ba(h, m)
            else:
                h = tlba.global_bundle_adjustment_async(cfg, m, "cpu", n_iters=20)
                assert isinstance(h.res.kf_pose, torch.Tensor)
                grow(P, m, Xw, tcw)
                tlba.apply_global_ba(h, m)
        maps[name] = m
    mt, mj = maps["torch"], maps["jax"]
    assert_same_map(mt, mj, 1e-5, 1e-4)
    assert np.linalg.norm(mt.kf_pose[5][:3, 3] - tcw(0.3 * 5, 0.05 * 5)[:3, 3]) > 1e-3
    if deferred:
        # the interim keyframe rode its parent's (KF5) correction
        rel_before = tcw(0.3 * 6, 0.05 * 6) @ np.linalg.inv(tcw(0.3 * 5, 0.05 * 5))
        rel_after = mt.kf_pose[6] @ np.linalg.inv(mt.kf_pose[5])
        np.testing.assert_allclose(rel_after, rel_before, atol=1e-3)

