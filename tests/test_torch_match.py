"""Port parity: ops/match.py (the tracking searches) against the JAX
package, on seeded synthetic scenes. Every output is an integer, and every
one must be equal: assignments, counts, gates.

The scenes hold what decides ties: keypoints duplicated with their
descriptor (equal Hamming distances, so the lower index must win as
``jnp.argmin``/``lax.top_k`` pick it), rotation histograms whose bin
counts tie, map points whose every candidate is masked, and points with a
single candidate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv_slam_tpu.geometry import se3 as jse3
from iv_slam_tpu.ops import match as jmatch
from iv_slam_tpu_torch.ops import match as tmatch

FX, FY, CX, CY, BF, W, H = 400.0, 400.0, 160.0, 120.0, 200.0, 320.0, 240.0
SCALES = (1.2 ** np.arange(4)).astype(np.float32)


def as_t(a):
    return torch.from_numpy(np.array(a))


def pose(xi):
    return np.asarray(jse3.se3_exp(jnp.asarray(np.asarray(xi, np.float32))))


def make_scene(rng, n_pts=300, n_extra=120, n_dup=40):
    """Map points in front of the camera and the current frame's keypoints:
    noisy projections of most points (descriptors with a few bits flipped,
    stereo u_right for some), random clutter, and duplicates of some
    keypoints (same descriptor, a pixel away)."""
    T_true = pose([0.01, -0.02, 0.01, 0.1, -0.05, 0.2])
    pc = np.stack([rng.uniform(-6, 6, n_pts), rng.uniform(-4, 4, n_pts),
                   rng.uniform(4, 25, n_pts)], 1).astype(np.float32)
    Tinv = np.linalg.inv(T_true)
    pw = (pc @ Tinv[:3, :3].T + Tinv[:3, 3]).astype(np.float32)
    pt_desc = rng.integers(0, 256, (n_pts, 32), dtype=np.uint8)
    pt_oct = rng.integers(0, 4, n_pts).astype(np.int32)
    pt_angle = rng.uniform(0, 360, n_pts).astype(np.float32)

    seen = rng.uniform(size=n_pts) < 0.8
    u = FX * pc[:, 0] / pc[:, 2] + CX + rng.normal(0, 0.6, n_pts)
    v = FY * pc[:, 1] / pc[:, 2] + CY + rng.normal(0, 0.6, n_pts)
    kp_xy = np.stack([u, v], 1)[seen]
    kp_desc = pt_desc[seen].copy()
    flips = rng.integers(0, 40, len(kp_desc))
    for i, k in enumerate(flips):  # flip k random bits
        bits = rng.choice(256, k, replace=False)
        np.bitwise_xor.at(kp_desc[i], bits // 8, (1 << (bits % 8)).astype(np.uint8))
    kp_oct = np.clip(pt_oct[seen] + rng.integers(-1, 2, seen.sum()), 0, 3)
    # a dominant rotation of ~24 deg plus outliers
    kp_angle = (pt_angle[seen] + 24 + rng.normal(0, 3, seen.sum())) % 360
    kp_angle[rng.uniform(size=len(kp_angle)) < 0.15] = rng.uniform(0, 360)
    z = pc[seen, 2]
    kp_ur = np.where(rng.uniform(size=len(z)) < 0.6, kp_xy[:, 0] - BF / z
                     + rng.normal(0, 0.5, len(z)), -1.0)

    ex_xy = np.stack([rng.uniform(0, W, n_extra), rng.uniform(0, H, n_extra)], 1)
    dup = rng.choice(len(kp_xy), n_dup, replace=False)
    xy = np.concatenate([kp_xy, ex_xy, kp_xy[dup] + rng.choice([-1.0, 1.0], (n_dup, 2))])
    desc = np.concatenate([kp_desc, rng.integers(0, 256, (n_extra, 32), dtype=np.uint8),
                           kp_desc[dup]])
    octave = np.concatenate([kp_oct, rng.integers(0, 4, n_extra), kp_oct[dup]])
    angle = np.concatenate([kp_angle, rng.uniform(0, 360, n_extra), kp_angle[dup]])
    ur = np.concatenate([kp_ur, -np.ones(n_extra), kp_ur[dup]])
    m = len(xy)
    perm = rng.permutation(m)
    cur = dict(xy=xy[perm].astype(np.float32), octave=octave[perm].astype(np.int32),
               angle=angle[perm].astype(np.float32), desc=desc[perm],
               ur=ur[perm].astype(np.float32),
               valid=rng.uniform(size=m) < 0.95)
    pts = dict(world=pw, desc=pt_desc, octave=pt_oct, angle=pt_angle,
               valid=rng.uniform(size=n_pts) < 0.93)
    return T_true, cur, pts


def both(fn_j, fn_t, args_np, consts):
    """Call the JAX function on jnp arrays and the port on tensors."""
    out_j = fn_j(*(jnp.asarray(a) for a in args_np),
                 *(jnp.asarray(np.float32(c)) if np.ndim(c) == 0 else jnp.asarray(c)
                   for c in consts))
    out_t = fn_t(*(as_t(a) for a in args_np),
                 *(torch.tensor(np.float32(c)) if np.ndim(c) == 0 else as_t(c)
                   for c in consts))
    return out_j, out_t


def test_resolve_one_to_one_matches_jax(rng):
    for n, m in ((50, 8), (400, 300), (7, 30)):
        best_j = rng.integers(0, m, n).astype(np.int32)
        best_d = rng.integers(0, 6, n).astype(np.int32)  # many equal distances
        ok = rng.uniform(size=n) < 0.8
        aj, wj = jmatch.resolve_one_to_one(*map(jnp.asarray, (best_j, best_d, ok)), m)
        at, wt = tmatch.resolve_one_to_one(*map(as_t, (best_j, best_d, ok)), m)
        assert at.dtype == torch.int32
        np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))


@pytest.mark.parametrize("counts", [
    [5, 5, 5, 5],       # four bins tie: the three lowest win
    [9, 4, 4, 4, 1],    # second to fourth tie below the first
    [3, 7, 3, 7],       # two pairs of ties
    [12, 1, 1],         # below the 10% share: kept only the first
    [],                 # nothing matched
])
def test_rotation_consistency_mask_ties_match_jax(rng, counts):
    bins = rng.permutation(30)[:max(len(counts), 1)]
    diffs = np.concatenate([np.full(c, bins[i] * 12.0) for i, c in enumerate(counts)]
                           + [rng.uniform(0, 360, 20)])
    diffs += rng.uniform(-2, 2, len(diffs))
    matched = np.concatenate([np.ones(sum(counts), bool), np.zeros(20, bool)])
    a_cur = rng.uniform(0, 360, len(diffs)).astype(np.float32)
    a_q = ((a_cur + diffs) % 360).astype(np.float32)
    mj = jmatch.rotation_consistency_mask(jnp.asarray(a_q), jnp.asarray(a_cur),
                                          jnp.asarray(matched))
    mt = tmatch.rotation_consistency_mask(as_t(a_q), as_t(a_cur), as_t(matched))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


@pytest.mark.parametrize("motion", ["forward", "backward", "sideways"])
@pytest.mark.parametrize("check_orientation", [True, False])
def test_search_by_projection_last_frame_matches_jax(motion, check_orientation):
    rng = np.random.default_rng(["forward", "backward", "sideways"].index(motion))
    T_true, cur, pts = make_scene(rng)
    T_cw = pose([0.002, 0.0, -0.001, 0.03, 0.0, -0.02]) @ T_true
    dz = {"forward": -0.8, "backward": 0.8, "sideways": 0.1}[motion]
    T_lw = pose([0, 0, 0, 0.05, 0, dz]) @ T_cw  # the last pose, b = 0.5 away
    args = (cur["xy"], cur["octave"], cur["angle"], cur["desc"], cur["ur"], cur["valid"],
            pts["world"], pts["desc"], pts["octave"], pts["angle"], pts["valid"],
            T_cw.astype(np.float32), T_lw.astype(np.float32))
    consts = (FX, FY, CX, CY, BF, BF / FX, W, H, SCALES, 7.0 * 1.2)
    (aj, nj), (at, nt) = both(
        lambda *a: jmatch.search_by_projection_last_frame(
            *a, check_orientation=check_orientation),
        lambda *a: tmatch.search_by_projection_last_frame(
            *a, check_orientation=check_orientation), args, consts)
    assert at.dtype == torch.int32 and nt.dtype == torch.int32
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    assert int(nt) == int(nj) > 50


def _local_inputs(rng):
    T_true, cur, pts = make_scene(rng, n_pts=500)
    T_cw = pose([0.001, 0.0, 0.002, -0.02, 0.01, 0.03]) @ T_true
    center = np.linalg.inv(T_cw)[:3, 3]
    po = pts["world"] - center
    dist = np.linalg.norm(po, axis=1)
    normal = po / dist[:, None]
    # some points seen from far off their normal (view_cos < 0.5 or 0.998)
    tilt = rng.uniform(size=len(dist)) < 0.3
    normal[tilt] = rng.normal(size=(tilt.sum(), 3))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    max_d = dist * SCALES[pts["octave"]] * rng.uniform(0.9, 1.3, len(dist))
    min_d = max_d / SCALES[-1]
    # every candidate of these points masked: behind the camera, invalid
    pts["world"][:10] = center + (center - pts["world"][:10])
    has_point = rng.uniform(size=len(cur["xy"])) < 0.2
    return T_cw, cur, pts, normal.astype(np.float32), min_d.astype(np.float32), \
        max_d.astype(np.float32), has_point


@pytest.mark.parametrize("seed", [0, 1])
def test_frustum_gate_and_local_map_search_match_jax(seed):
    rng = np.random.default_rng(10 + seed)
    T_cw, cur, pts, normal, min_d, max_d, has_point = _local_inputs(rng)
    if seed == 1:
        # one candidate per point at most: keypoints far apart, single octave
        cur["xy"] = np.stack([rng.uniform(0, W, len(cur["xy"])),
                              rng.uniform(0, H, len(cur["xy"]))], 1).astype(np.float32)
    gate_args = (pts["world"], normal, min_d, max_d, pts["valid"], T_cw.astype(np.float32))
    gj, gt = both(jmatch.frustum_gate, tmatch.frustum_gate, gate_args,
                  (FX, FY, CX, CY, W, H))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    assert 0 < int(gt.sum()) < len(gt)

    args = (cur["xy"], cur["octave"], cur["desc"], cur["ur"], cur["valid"], has_point,
            pts["world"], pts["desc"], normal, min_d, max_d, pts["valid"],
            T_cw.astype(np.float32))
    consts = (FX, FY, CX, CY, BF, W, H, SCALES, np.log(1.2), 1.2, 0.8 * 0.95)
    (aj, nj), (at, nt) = both(jmatch.search_by_projection_local_map,
                              tmatch.search_by_projection_local_map, args, consts)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    assert int(nt) == int(nj)
    if seed == 0:
        assert int(nt) > 100
