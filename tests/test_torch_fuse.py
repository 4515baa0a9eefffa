"""Port parity: the fuse functions of ops/match.py (ORBmatcher::Fuse over
target keyframes x candidate points, LocalMapping::SearchInNeighbors'
projection pass) against the JAX package's, jitted, in the no-FMA
subprocess (tests/torch_parity.py).

Synthetic targets at tests/synth_world.py's camera (240x320): keypoints are
noisy projections of map points (descriptors a few bits off the points',
60% of them stereo), plus clutter. Candidate points are rows of a 1024-row
map table chosen by an index vector whose last entries are padding at and
beyond the table's capacity; one target slot of four is padding (kf_ok
False). Cases: that set with the reprojection gate, the same without it
(``scw``, the loop-closing variant), and 16 copies of one target against
600 visible points, more matches than F_CAP.

Exact: the dense (NB, P) assignment, the compacted triples and the count,
and the indexed form equal to the table-upload form.
"""

import numpy as np
import pytest
import torch

from iv_slam_tpu_torch.geometry import se3
from iv_slam_tpu_torch.ops import match
from torch_parity import one_thread  # noqa: F401 (fixture)
from torch_parity import FUSE_KF, FUSE_MAP, FUSE_PT, FUSE_TAIL, run_reference

pytestmark = pytest.mark.usefixtures("one_thread")

CAM = (400.0, 400.0, 160.0, 120.0, 200.0, 320, 240)
N_LEVELS = 8
CAP = 1024


def fuse_case(rng, nb_real, nb_cap, n_kp, n_pt, seen, spread=6.0, same_target=False,
              scw=False):
    fx, fy, cx, cy, bf, W, H = CAM
    sf = (1.2 ** np.arange(N_LEVELS)).astype(np.float32)
    pos = np.stack([rng.uniform(-spread, spread, CAP),
                    rng.uniform(-spread * 2 / 3, spread * 2 / 3, CAP),
                    rng.uniform(6, 14, CAP)], 1).astype(np.float32)
    dist = np.linalg.norm(pos, axis=1)
    normal = (pos / dist[:, None]).astype(np.float32)
    octv = rng.integers(0, 4, CAP)
    maxd = (dist * sf[octv] * 1.01).astype(np.float32)
    mind = (maxd / sf[-1]).astype(np.float32)
    desc = rng.integers(0, 256, (CAP, 32), dtype=np.uint8)
    valid = rng.uniform(size=CAP) < 0.95
    pid_idx = rng.choice(CAP, n_pt, replace=False).astype(np.int32)
    pid_idx[-3:] = [CAP, CAP + 3, CAP + 1000]          # padding, at and past capacity

    def target_pose(i):
        xi = np.concatenate([rng.normal(0, 0.005, 3), rng.normal(0, 0.02, 3)])
        T = se3.se3_exp(torch.tensor(xi, dtype=torch.float32)).numpy()
        T[0, 3] -= 0.2 * i
        return T

    T0 = target_pose(0)
    Ts = [T0 if same_target else target_pose(i) for i in range(nb_real)]
    kf = {k: [] for k in FUSE_KF}
    for T in Ts + [Ts[0]] * (nb_cap - nb_real):
        rows = pid_idx[:-3]
        pc = pos[rows] @ T[:3, :3].T + T[:3, 3]
        u = fx * pc[:, 0] / pc[:, 2] + cx
        v = fy * pc[:, 1] / pc[:, 2] + cy
        vis = rows[(u >= 2) & (u < W - 2) & (v >= 2) & (v < H - 2)]
        take = rng.permutation(vis)[: int(seen * len(vis))][:n_kp]
        k = len(take)
        pc = pos[take] @ T[:3, :3].T + T[:3, 3]
        xy = np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy], 1)
        # most within the reprojection gate, 30% a few pixels off
        xy = xy + rng.normal(0, 1, xy.shape) * np.where(rng.uniform(size=k) < 0.3, 1.5,
                                                       0.3)[:, None]
        d = desc[take].copy()
        for i in range(k):
            bits = rng.choice(256, rng.integers(0, 20), replace=False)
            np.bitwise_xor.at(d[i], bits // 8, (1 << (bits % 8)).astype(np.uint8))
        stereo = rng.uniform(size=k) < 0.6
        ur = np.where(stereo, xy[:, 0] - bf / pc[:, 2] + rng.normal(0, 0.3, k), -1.0)
        m = n_kp - k
        kf["kf_xy"].append(np.concatenate([xy, rng.uniform(0, [W, H], (m, 2))]))
        kf["kf_oct"].append(np.concatenate([octv[take], rng.integers(0, 4, m)]))
        kf["kf_desc"].append(np.concatenate([d, rng.integers(0, 256, (m, 32), dtype=np.uint8)]))
        kf["kf_valid"].append(rng.uniform(size=n_kp) < 0.97)
        kf["kf_ur"].append(np.concatenate([ur, np.where(rng.uniform(size=m) < 0.5, -1.0,
                                                        rng.uniform(0, W, m))]))
        kf["kf_T"].append(T)
    case = {k: np.stack(v) for k, v in kf.items()}
    case["kf_xy"] = case["kf_xy"].astype(np.float32)
    case["kf_ur"] = case["kf_ur"].astype(np.float32)
    case["kf_oct"] = case["kf_oct"].astype(np.int32)
    case["kf_T"] = case["kf_T"].astype(np.float32)
    kf_ok = np.arange(nb_cap) < nb_real
    r = np.minimum(pid_idx, CAP - 1)
    pt_ok = (pid_idx < CAP) & valid[r]
    case.update(pt_pos=pos[r], pt_desc=desc[r], pt_normal=normal[r], pt_mind=mind[r],
                pt_maxd=maxd[r], pt_mask_nb=kf_ok[:, None] & pt_ok[None, :],
                map_pos=pos, map_desc=desc, map_normal=normal, map_mind=mind, map_maxd=maxd,
                map_valid=valid, pid_idx=pid_idx, kf_ok=kf_ok, sf=sf,
                log_scale=np.float32(np.log(sf[1] / sf[0])), scw=np.bool_(scw),
                **{k: np.float32(v) for k, v in zip(("fx", "fy", "cx", "cy", "bf", "width",
                                                     "height"), (fx, fy, cx, cy, bf, W, H))},
                radius_th=np.float32(4.0 if scw else 3.0))
    return case


CASES = {
    "stereo and mono, padded": (0, dict(nb_real=3, nb_cap=4, n_kp=512, n_pt=400, seen=0.8)),
    "scw (no reprojection gate)": (0, dict(nb_real=3, nb_cap=4, n_kp=512, n_pt=400,
                                           seen=0.8, scw=True)),
    "F_CAP overflow": (1, dict(nb_real=16, nb_cap=16, n_kp=720, n_pt=700, seen=1.0,
                               spread=3.0, same_target=True)),
}


@pytest.fixture(scope="module")
def fuse_runs(tmp_path_factory):
    cases = [fuse_case(np.random.default_rng(seed), **kw) for seed, kw in CASES.values()]
    flat = {f"c{c}_{k}": v for c, case in enumerate(cases) for k, v in case.items()}
    ref = run_reference("fuse", tmp_path_factory.mktemp("fuse"), n_cases=len(cases), **flat)
    return cases, ref


@pytest.mark.parametrize("name", list(CASES))
def test_fuse_matches_jax(fuse_runs, name):
    cases, ref = fuse_runs
    c = list(CASES).index(name)
    case = cases[c]
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in case.items()}
    scw = bool(case["scw"])
    kf = [t[k] for k in FUSE_KF]
    tail = [t[k] for k in FUSE_TAIL]
    dense = match.fuse_into_keyframes(*kf, *(t[k] for k in FUSE_PT), *tail, scw=scw)
    compact = match.fuse_into_keyframes_compact(*kf, *(t[k] for k in FUSE_PT), *tail, scw=scw)
    indexed = match.fuse_into_keyframes_compact_indexed(
        *kf, t["kf_ok"], *(t[k] for k in FUSE_MAP), t["pid_idx"], *tail, scw=scw)
    assert dense.dtype == torch.int32
    np.testing.assert_array_equal(dense.numpy(), ref[f"c{c}_dense"])
    np.testing.assert_array_equal(compact.numpy(), ref[f"c{c}_compact"])
    np.testing.assert_array_equal(indexed.numpy(), ref[f"c{c}_indexed"])
    np.testing.assert_array_equal(indexed.numpy(), compact.numpy())

    count = int(compact[-1])
    triples = compact[:-1].reshape(match.F_CAP, 3).numpy().astype(np.int64)
    n = min(count, match.F_CAP)
    assert (triples[n:] == 0).all()
    t_, i, feat = triples[:n].T
    # (target-major, point) order; the padded target and the padded point
    # rows (pid_idx >= capacity) never match
    assert (np.diff(t_ * case["pid_idx"].shape[0] + i) > 0).all()
    assert (t_ < case["kf_ok"].sum()).all() and (case["pid_idx"][i] < CAP).all()
    assert (dense.numpy()[t_, i] == feat).all()
    ur = case["kf_ur"][t_, feat]
    if name == "F_CAP overflow":
        assert count > match.F_CAP, count
    else:
        assert 300 < count < match.F_CAP and (ur >= 0).any() and (ur < 0).any(), count
    if name.startswith("scw"):
        gated = ref["c0_compact"][-1]
        assert count > gated, (count, gated)
