"""Port parity: the tracking slice, slam/fused_track.py on the port's
frontend, map store and device map, against the JAX package.

* The slice as a whole: two tests/synth_world.py frames at 240x320. The
  port's StereoFrontend (CPU), a map from frame 0 (MapStore calls of
  Tracking._stereo_initialization, DeviceMap.sync), FusedTracker.track of
  frame 1; against the same chain in the JAX package (jitted, no FMA
  contraction: tests/torch_parity.py).
* Synthetic steps at N = 2048 keypoint slots (the pose LM on its compacted
  1536-row table) against a P = 16384 map table (the local search on its
  compacted 4096 rows), with last-frame slots >= the table size (cleared by
  a map reset) among the inputs: once within both caps, once over both.

Integer outputs (assignments, inlier flags, counts, the host pack's integer
columns) must be equal. chi2 is a function of the pose: at the final
inliers the port evaluates it at the reference's pose (rtol 1e-4);
elsewhere, where it holds residuals of outliers and of unmatched slots, it
is compared as it comes (rtol 1e-4).

The pose: within 1e-5 (solvers/pose_opt.py's tolerance; 4e-6 seen). Ten LM
iterations do not settle a direction the edges constrain weakly (a turn
and a shift over a plane), so where a round ends there depends on the
float32 rounding of H: the port keeps it (numerics.tree_sum), and an H
summed in float64 would end ~2e-4 from the reference on the slice.
"""

import numpy as np
import pytest
import torch

from iv_slam_tpu_torch import config as tconfig
from iv_slam_tpu_torch.geometry import se3
from iv_slam_tpu_torch.slam.device_map import DeviceMap
from iv_slam_tpu_torch.slam.frame import StereoFrontend
from iv_slam_tpu_torch.slam.fused_track import LOCAL_CAP, FusedTracker, pose_cap
from iv_slam_tpu_torch.slam.map_store import MapStore
from iv_slam_tpu_torch.solvers import pose_opt
from synth_world import make_sequence
from torch_parity import STEP_INPUTS, init_map, run_reference

KITTI = (718.856, 718.856, 620.5, 188.0, 0.54 * 718.856, 1241, 376)


def port_config(cam, n_features, n_levels):
    fx, fy, cx, cy, bf, w, h = cam
    cfg = tconfig.Config()
    cfg.camera = tconfig.CameraConfig(fx=fx, fy=fy, cx=cx, cy=cy, bf=bf, width=int(w),
                                      height=int(h))
    cfg.orb = tconfig.ORBConfig(n_features=n_features, n_levels=n_levels)
    return cfg


def check_result(res, flat, ref, tr, step_in, N):
    """Equal integers, the pose within 1e-5, chi2 as the module says."""
    assert res.assign_map.dtype == torch.int32 and res.n_motion.dtype == torch.int32
    for f in ("assign_map", "inlier", "n_motion", "n_final"):
        np.testing.assert_array_equal(getattr(res, f).numpy(), ref[f], err_msg=f)
    np.testing.assert_allclose(res.T.numpy(), ref["T"], rtol=0, atol=1e-5)
    inl = ref["inlier"]
    chi2 = res.chi2.numpy()
    np.testing.assert_allclose(chi2[~inl], ref["chi2"][~inl], rtol=1e-4)
    slots = torch.from_numpy(ref["assign_map"][inl]).long()
    obs = torch.cat([step_in["cur_xy"], step_in["cur_ur"][:, None]], 1)[inl]
    e, _ = pose_opt._residuals(torch.from_numpy(ref["T"]), step_in["map_pos"][slots], obs,
                               obs[:, 2] >= 0, tr.K)
    inv_s2 = tr.inv_level_sigma2[step_in["cur_oct"][inl]]
    np.testing.assert_allclose(pose_opt._chi2(e, inv_s2).numpy(), ref["chi2"][inl],
                               rtol=1e-4)
    # the host pack: every column but chi2 exact, then the pose, then counts
    flat_ref, flat = ref["flat"], flat.numpy()
    assert flat.shape == flat_ref.shape == (N * 10 + 20,)
    pack, pack_ref = flat[:N * 10].reshape(N, 10), flat_ref[:N * 10].reshape(N, 10)
    np.testing.assert_array_equal(pack[:, :9], pack_ref[:, :9])
    np.testing.assert_array_equal(flat[N * 10 + 16:], flat_ref[N * 10 + 16:])
    return flat[N * 10 + 16:]


# ---- the slice as a whole ---------------------------------------------------

@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    rng = np.random.default_rng(7)
    world, frames, gt = make_sequence(rng, n_frames=2, step=0.08)
    cam = (400.0, 400.0, 160.0, 120.0, float(world.bf), world.w, world.h)
    ref = run_reference("fused_slice", tmp_path_factory.mktemp("slice"),
                        left0=frames[0][0], right0=frames[0][1], left1=frames[1][0],
                        right1=frames[1][1], cam=np.array(cam), n_features=800,
                        n_levels=4)
    cfg = port_config(cam, 800, 4)
    fe = StereoFrontend(cfg, world.h, world.w, device="cpu")
    f0 = fe.process(*frames[0], 0.0)
    f1 = fe.process(*frames[1], 0.1)
    m = MapStore(n_levels=4, scale_factor=cfg.orb.scale_factor)
    init_map(m, f0, cfg.camera)
    dmap = DeviceMap(device="cpu")
    dmap.sync(m)
    tr = FusedTracker(cfg, world.h, world.w, device="cpu")
    res, flat = tr.track(f1, f0, f0.map_pt, f0.pose, dmap)
    step_in = dict(cur_xy=f1.kp.xy, cur_ur=f1.ur_dev, cur_oct=f1.kp.octave,
                   map_pos=dmap.live_views()[0])
    return ref, res, flat, tr, step_in, f0, m, dmap, gt


def test_slice_fused_step_matches_jax(slice_run):
    ref, res, flat, tr, step_in, f0, m, dmap, gt = slice_run
    N = f0.map_pt.shape[0]
    # the map the step ran against is the reference's
    np.testing.assert_array_equal(f0.map_pt, ref["map_pt0"])
    assert m.n_points == int(ref["n_points"]) > 300
    for f, v in zip(("pos", "desc", "normal", "mind", "maxd", "qual", "valid"),
                    dmap.live_views()):
        np.testing.assert_array_equal(v.numpy(), ref["map_" + f], err_msg=f)
    counts = check_result(res, flat, ref, tr, step_in, N)
    n_motion, n_final, n_gate, ovf = counts
    assert n_motion >= 100 and n_final >= 100 and ovf == 0, counts
    # frame 1 is 0.08 m from frame 0; over a plane 10 m away a small turn
    # and a shift look alike, so the pose is held to a few centimetres
    T_gt = np.linalg.inv(gt[1]) @ gt[0]
    assert np.abs(res.T.numpy()[:3, 3] - T_gt[:3, 3]).max() < 0.05


def test_track_reads_the_frames_device_tensors(slice_run):
    """track() hands the step the tensors the frontend left on the frame."""
    ref, res, flat, tr, step_in, f0, m, dmap, gt = slice_run
    seen = {}
    orig = tr._step
    tr._step = lambda *a: seen.setdefault("args", a) and orig(*a)
    try:
        tr.track(f0, f0, f0.map_pt, f0.pose, dmap)
    finally:
        tr._step = orig
    args = seen["args"]
    assert args[4] is f0.ur_dev and args[6] is f0.qual_dev and args[7] is f0.depth_dev
    assert args[0] is f0.kp.xy and args[3] is f0.kp.desc
    assert args[12].dtype == torch.int32 and args[13].dtype == torch.float32


# ---- synthetic steps at the compaction sizes --------------------------------

def synthetic_step(rng, n_map, spread, n_last, n_cur, N=2048, P=16384):
    """Map points in front of a KITTI-sized camera at the identity (the last
    frame), the current frame moved a little; keypoints are noisy
    projections with descriptors a few bits off the points', plus clutter.
    Some last-frame slots lie beyond the table."""
    fx, fy, cx, cy, bf, W, H = KITTI
    pos = np.zeros((P, 3), np.float32)
    pos[:n_map] = np.stack([rng.uniform(-spread, spread, n_map),
                            rng.uniform(-spread / 3, spread / 3, n_map),
                            rng.uniform(6, 40, n_map)], 1)
    dist = np.linalg.norm(pos, axis=1)
    normal = pos / np.maximum(dist, 1e-9)[:, None]
    octave = rng.integers(0, 8, P).astype(np.int32)
    sf = 1.2 ** octave
    maxd = (dist * sf).astype(np.float32)
    mind = (maxd / 1.2 ** 7).astype(np.float32)
    desc = rng.integers(0, 256, (P, 32), dtype=np.uint8)
    valid = np.zeros(P, bool)
    valid[:n_map] = rng.uniform(size=n_map) < 0.97
    # the last row: a copy of the point nearest the optical axis, so that
    # slots beyond the table, were they clipped into it and not gated out,
    # would find matches
    j = np.argmin(np.abs(pos[:n_map, :2] / pos[:n_map, 2:]).sum(1))
    pos[P - 1], normal[P - 1], desc[P - 1] = pos[j], normal[j], desc[j]
    maxd[P - 1], mind[P - 1], octave[P - 1], valid[P - 1] = maxd[j], mind[j], octave[j], True

    T_true = se3.se3_exp(torch.tensor([0.004, -0.006, 0.002, 0.05, -0.02, 0.6])).numpy()

    def view(T, idx, noise):
        pc = pos[idx] @ T[:3, :3].T + T[:3, 3]
        u = fx * pc[:, 0] / pc[:, 2] + cx + rng.normal(0, noise, len(idx))
        v = fy * pc[:, 1] / pc[:, 2] + cy + rng.normal(0, noise, len(idx))
        return np.stack([u, v], 1).astype(np.float32), pc[:, 2]

    def flip(d, k_max):
        d = d.copy()
        for i in range(len(d)):
            bits = rng.choice(256, rng.integers(0, k_max), replace=False)
            np.bitwise_xor.at(d[i], bits // 8, (1 << (bits % 8)).astype(np.uint8))
        return d

    def inside(xy):
        return (xy[:, 0] >= 0) & (xy[:, 0] < W) & (xy[:, 1] >= 0) & (xy[:, 1] < H)

    # last frame: n_last keypoints on visible points, the rest clutter
    ids = np.arange(n_map)
    xy_l, _ = view(np.eye(4, dtype=np.float32), ids, 0.0)
    vis = ids[inside(xy_l) & valid[:n_map] & (ids != j)]
    take = rng.choice(vis, min(n_last, len(vis)), replace=False)
    last_xy = np.concatenate([xy_l[take], rng.uniform(0, [W, H], (N - len(take), 2))])
    last_oct = np.concatenate([octave[take], rng.integers(0, 8, N - len(take))])
    last_ids = np.concatenate([take, -np.ones(N - len(take), np.int64)]).astype(np.int32)
    reset = rng.choice(len(take), 40, replace=False)
    last_ids[reset] = P + rng.integers(0, 5000, 40)       # cleared by a map reset
    last_angle = rng.uniform(0, 360, N).astype(np.float32)

    # current frame: the visible points the camera sees after moving,
    # point j among them
    xy_c, z_c = view(T_true, ids, 0.5)
    seen = ids[inside(xy_c) & (rng.uniform(size=n_map) < 0.9) & (ids != j)]
    seen = np.concatenate([[j], rng.permutation(seen)[:n_cur - 1]])
    k = len(seen)
    cur_xy = np.concatenate([xy_c[seen], rng.uniform(0, [W, H], (N - k, 2))]).astype(np.float32)
    cur_desc = np.concatenate([flip(desc[seen], 30),
                               rng.integers(0, 256, (N - k, 32), dtype=np.uint8)])
    cur_oct = np.concatenate([np.clip(octave[seen] + rng.integers(-1, 2, k), 0, 7),
                              rng.integers(0, 8, N - k)]).astype(np.int32)
    # the last frame's keypoint angles, turned by 10 degrees
    angle_of = dict(zip(take.tolist(), last_angle[:len(take)].tolist()))
    cur_angle = np.array([angle_of.get(int(s), rng.uniform(0, 360)) + 10.0 for s in seen]
                         + list(rng.uniform(0, 360, N - k)), np.float32) % 360
    stereo = rng.uniform(size=N) < 0.6
    z = np.concatenate([z_c[seen], rng.uniform(6, 40, N - k)])
    cur_ur = np.where(stereo, cur_xy[:, 0] - bf / z, -1.0).astype(np.float32)
    cur_depth = np.where(stereo, z, -1.0).astype(np.float32)
    # the reset slots look like point j's keypoint in the last frame: its
    # angle, turned back; octave 7, which the backward-motion test passes
    last_angle[reset] = (cur_angle[0] - 10.0) % 360
    last_oct[reset] = 7
    perm = rng.permutation(N)
    cur_valid = rng.uniform(size=N) < 0.97
    cur_valid[np.argmax(perm == 0)] = True
    T_pred = (se3.se3_exp(torch.tensor([0.001, 0.0, -0.001, 0.01, 0.01, -0.03])).numpy()
              @ T_true)
    return dict(
        cur_xy=cur_xy[perm], cur_oct=cur_oct[perm], cur_angle=cur_angle[perm],
        cur_desc=cur_desc[perm], cur_ur=cur_ur[perm],
        cur_valid=cur_valid, cur_qual=rng.uniform(0.5, 1, N)
        .astype(np.float32), cur_depth=cur_depth[perm],
        last_xy=last_xy.astype(np.float32), last_oct=last_oct.astype(np.int32),
        last_angle=last_angle, last_valid=(rng.uniform(size=N) < 0.98) | (last_ids >= P),
        last_pt_ids=last_ids, T_pred=T_pred.astype(np.float32),
        T_last=np.eye(4, dtype=np.float32), map_pos=pos, map_desc=desc,
        map_normal=normal.astype(np.float32), map_mind=mind, map_maxd=maxd,
        map_qual=rng.uniform(0.5, 1, P).astype(np.float32), map_valid=valid)


# (seed, synthetic_step arguments); one shape, so one JAX compile for all
CASES = {
    "within caps": (1, dict(n_map=7000, spread=30.0, n_last=1200, n_cur=1450)),
    "over the pose cap": (0, dict(n_map=7000, spread=30.0, n_last=1300, n_cur=1848)),
    "over the local cap": (2, dict(n_map=12000, spread=25.0, n_last=1900, n_cur=1900)),
}


@pytest.fixture(scope="module")
def synthetic_runs(tmp_path_factory):
    cases = {name: synthetic_step(np.random.default_rng(seed), **kw)
             for name, (seed, kw) in CASES.items()}
    stacked = {k: np.stack([c[k] for c in cases.values()]) for k in STEP_INPUTS}
    ref = run_reference("fused_step", tmp_path_factory.mktemp("step"), cam=np.array(KITTI),
                        n_features=2000, n_levels=8, **stacked)
    return cases, ref


@pytest.mark.parametrize("name", list(CASES))
def test_compacted_fused_step_matches_jax(synthetic_runs, name):
    cases, refs = synthetic_runs
    i = list(CASES).index(name)
    ref = {k: v[i] for k, v in refs.items()}
    inp = {k: torch.from_numpy(v) for k, v in cases[name].items()}
    tr = FusedTracker(port_config(KITTI, 2000, 8), KITTI[6], KITTI[5], device="cpu")
    N, P = inp["cur_xy"].shape[0], inp["map_pos"].shape[0]
    assert pose_cap(N) == 1536 and P > LOCAL_CAP
    res, flat = tr._step(*(inp[k] for k in STEP_INPUTS))
    n_motion, n_final, n_gate, ovf = check_result(res, flat, ref, tr, inp, N)
    # the slots beyond the table were gated out, not clipped into matches
    beyond = inp["last_pt_ids"] >= P
    assert beyond.sum() == 40
    assert not np.isin(res.assign_map.numpy(), inp["last_pt_ids"][beyond].numpy()).any()
    n_edges = int((res.assign_map.numpy() >= 0).sum())
    if name == "within caps":
        assert n_gate <= LOCAL_CAP and ovf == 0 and 1024 < n_edges <= 1536
    elif name == "over the pose cap":
        assert n_gate <= LOCAL_CAP and ovf > 0 and n_final == 1536
    else:
        assert n_gate > LOCAL_CAP and ovf == 0
    assert n_motion > 200 and n_final > 900, (n_motion, n_final)
