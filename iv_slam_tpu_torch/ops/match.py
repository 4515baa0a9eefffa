"""Projection-window descriptor matching (ORBmatcher.cc SearchByProjection).

Port of the tracking part of ``iv_slam_tpu/ops/match.py``: each search is a
masked dense problem, an (nQuery, nKeypoint) Hamming matrix (hamming.py)
with window / octave / stereo-consistency masks applied before an argmin.

  * search_by_projection_last_frame: frame-to-frame motion-model tracking
    (ORBmatcher.cc:1372-1520), forward/backward octave gating and the
    30-bin rotation-consistency histogram
  * frustum_gate + search_by_projection_local_map: local-map tracking
    (Frame::isInFrustum + ORBmatcher.cc:178-270), best/second-best ratio
    test within the predicted scale band

Tie order follows the reference: ``lax.top_k`` puts the lower index first
among equal values and ``jnp.argmin`` returns the first minimum, so the
port takes a stable sort or first-index ``argmin``s, never ``torch.topk``
(which promises no order among ties). Every function is free of host
synchronisation, and rounds alike on the CPU and on the GPU (its roots,
logarithms and matrix products go through numerics.py).

Not ported in this slice: ``search_for_initialization`` (ROADMAP A9) and
the fuse functions (A6).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import numerics
from ..geometry import se3
from .hamming import hamming_matrix

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30

_BIG = 1 << 20


def resolve_one_to_one(best_j, best_d, ok, m):
    """Scatter-free one-to-one assignment resolution.

    Each of n claimants proposes target best_j with distance best_d (valid
    when ok); per target keep the lowest-distance claimant, ties broken by
    lowest claimant index.

    Returns (assign (m,) int32 claimant-or--1, wins (n,) bool)."""
    n = best_j.shape[0]
    dev = best_j.device
    n_idx = torch.arange(n, dtype=torch.int32, device=dev)
    W = best_j[:, None] == torch.arange(m, dtype=torch.int32, device=dev)[None, :]
    d_claim = torch.where(ok, best_d.to(torch.int32), _BIG)
    best_for = torch.where(W, d_claim[:, None], _BIG).amin(dim=0)
    wins = ok & (d_claim == best_for[best_j])
    first = torch.where(W & wins[:, None], n_idx[:, None], 1 << 30).amin(dim=0)
    wins = wins & (first[best_j] == n_idx)
    assign = torch.where(W & wins[:, None], n_idx[:, None], -1).amax(dim=0)
    return assign.to(torch.int32), wins


def rotation_consistency_mask(
    angle_query: torch.Tensor, angle_matched: torch.Tensor, matched: torch.Tensor
) -> torch.Tensor:
    """Keep only matches whose angle difference falls in the 3 dominant
    30-bin histogram bins (ORBmatcher::ComputeThreeMaxima). Among bins of
    equal count the lower bin ranks first, as ``lax.top_k`` orders them."""
    rot = angle_query - angle_matched
    rot = torch.where(rot < 0.0, rot + 360.0, rot)
    bin_idx = torch.round(rot * (HISTO_LENGTH / 360.0)).to(torch.int32)
    bin_idx = torch.where(bin_idx == HISTO_LENGTH, 0, bin_idx)
    bins = torch.arange(HISTO_LENGTH, dtype=torch.int32, device=rot.device)
    counts = ((bin_idx[:, None] == bins[None, :]) & matched[:, None]).sum(
        dim=0, dtype=torch.int32)
    top_c, top_i = torch.sort(counts, descending=True, stable=True)
    c1, c2, c3 = top_c[0], top_c[1], top_c[2]
    i1, i2, i3 = top_i[0], top_i[1], top_i[2]
    keep2 = c2.to(torch.float32) >= 0.1 * c1.to(torch.float32)
    keep3 = c3.to(torch.float32) >= 0.1 * c1.to(torch.float32)
    ok = (
        (bin_idx == i1)
        | ((bin_idx == i2) & keep2)
        | ((bin_idx == i3) & keep3)
    )
    return matched & ok


def _project(T_cw, pt_world, fx, fy, cx, cy, img_w, img_h):
    """Camera-frame points, their pixels and the in-image test, written as
    the reference writes them (``1 / where(z != 0, z, 1)``, then
    ``fx * x * invz + cx``)."""
    pc = se3.transform_points(T_cw, pt_world)
    z = pc[:, 2]
    invz = 1.0 / torch.where(z != 0, z, torch.ones_like(z))
    u = fx * pc[:, 0] * invz + cx
    v = fy * pc[:, 1] * invz + cy
    in_img = (z > 0) & (u >= 0) & (u < img_w) & (v >= 0) & (v < img_h)
    return invz, u, v, in_img


def _stereo_ok(u, invz, bf, cur_ur, r):
    ur_pred = u[:, None] - bf * invz[:, None]
    return torch.where(
        cur_ur[None, :] > 0,
        torch.abs(ur_pred - cur_ur[None, :]) <= r[:, None],
        True,
    )


def search_by_projection_last_frame(
    # current frame keypoints
    cur_xy: torch.Tensor,       # (M, 2)
    cur_octave: torch.Tensor,   # (M,)
    cur_angle: torch.Tensor,    # (M,)
    cur_desc: torch.Tensor,     # (M, 32)
    cur_ur: torch.Tensor,       # (M,) u_right (-1 mono)
    cur_valid: torch.Tensor,    # (M,)
    # last-frame tracked map points
    pt_world: torch.Tensor,     # (N, 3)
    pt_desc: torch.Tensor,      # (N, 32) map-point distinctive descriptors
    pt_octave: torch.Tensor,    # (N,) octave of the last-frame observation
    pt_angle: torch.Tensor,     # (N,) angle of the last-frame keypoint
    pt_valid: torch.Tensor,     # (N,)
    # geometry
    T_cw: torch.Tensor,         # (4, 4) current pose
    T_lw: torch.Tensor,         # (4, 4) last pose
    fx, fy, cx, cy, bf, b,      # 0-d float32 tensors
    img_w, img_h,
    scale_factors: torch.Tensor,
    th: torch.Tensor,           # search window base (0-d)
    check_orientation: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (assign, n_matches): assign[j] = index into pt arrays for
    current keypoint j, or -1 (int32)."""
    invz, u, v, in_img = _project(T_cw, pt_world, fx, fy, cx, cy, img_w, img_h)
    proj_ok = pt_valid & in_img

    # forward/backward translation along optical axis (ORBmatcher.cc:1387-1393)
    twc = se3.inverse(T_cw)[:3, 3]
    tlc = numerics.matmul(T_lw[:3, :3], twc[:, None])[:, 0] + T_lw[:3, 3]
    forward = tlc[2] > b
    backward = -tlc[2] > b

    radius = th * scale_factors[pt_octave]  # (N,)
    du = torch.abs(cur_xy[:, 0][None, :] - u[:, None])  # (N, M)
    dv = torch.abs(cur_xy[:, 1][None, :] - v[:, None])
    in_window = (du < radius[:, None]) & (dv < radius[:, None])

    co = cur_octave[None, :]
    po = pt_octave[:, None]
    oct_ok = torch.where(forward, co >= po,
                         torch.where(backward, co <= po, torch.abs(co - po) <= 1))

    mask = (proj_ok[:, None] & cur_valid[None, :] & in_window & oct_ok
            & _stereo_ok(u, invz, bf, cur_ur, radius))
    dist = hamming_matrix(pt_desc, cur_desc)  # (N, M)
    masked = torch.where(mask, dist, _BIG)
    best_j = torch.argmin(masked, dim=1).to(torch.int32)  # first minimum
    best_d = torch.gather(masked, 1, best_j[:, None].long())[:, 0]
    point_matched = best_d <= TH_HIGH

    # resolve conflicts: keep lowest distance per current keypoint
    assign, _wins = resolve_one_to_one(best_j, best_d, point_matched, cur_xy.shape[0])
    matched_kp = assign >= 0

    if check_orientation:
        safe_assign = torch.clamp(assign, min=0)
        matched_kp = rotation_consistency_mask(pt_angle[safe_assign], cur_angle,
                                               matched_kp)
        assign = torch.where(matched_kp, assign, -1)
    return assign, matched_kp.sum(dtype=torch.int32)


def _radius_by_viewing_cos(cos_v: torch.Tensor) -> torch.Tensor:
    return torch.where(cos_v > 0.998, 2.5, 4.0)


def _frustum(pt_world, pt_normal, pt_min_dist, pt_max_dist, pt_valid,
             T_cw, fx, fy, cx, cy, img_w, img_h):
    """Frame::isInFrustum pieces shared by frustum_gate and the local-map
    search: projection, distance to the camera, viewing cosine, gate."""
    invz, u, v, in_img = _project(T_cw, pt_world, fx, fy, cx, cy, img_w, img_h)
    cam_center = se3.inverse(T_cw)[:3, 3]
    po_vec = pt_world - cam_center[None, :]
    # jnp.linalg.norm of a 3-vector: sqrt of the squares summed left to right
    dist = numerics.sqrt(se3.sum3(po_vec, po_vec))
    dist_ok = (dist >= 0.8 * pt_min_dist) & (dist <= 1.2 * pt_max_dist)
    view_cos = se3.sum3(po_vec, pt_normal) / torch.clamp(dist, min=1e-9)
    gate = pt_valid & in_img & dist_ok & (view_cos >= 0.5)
    return invz, u, v, dist, view_cos, gate


def frustum_gate(
    pt_world, pt_normal, pt_min_dist, pt_max_dist, pt_valid,
    T_cw, fx, fy, cx, cy, img_w, img_h,
):
    """Frame::isInFrustum as a (P,) mask: projection in-image +
    scale-invariance distance band + viewing angle < 60 deg, the exact
    per-point gate search_by_projection_local_map applies before its pair
    matrix, so the fused step can compact the map table to the survivors
    first."""
    return _frustum(pt_world, pt_normal, pt_min_dist, pt_max_dist, pt_valid,
                    T_cw, fx, fy, cx, cy, img_w, img_h)[-1]


def search_by_projection_local_map(
    cur_xy: torch.Tensor,
    cur_octave: torch.Tensor,
    cur_desc: torch.Tensor,
    cur_ur: torch.Tensor,
    cur_valid: torch.Tensor,
    cur_has_point: torch.Tensor,   # (M,) bool: keypoint already matched
    # candidate local map points
    pt_world: torch.Tensor,        # (N, 3)
    pt_desc: torch.Tensor,
    pt_normal: torch.Tensor,       # (N, 3) mean viewing direction
    pt_min_dist: torch.Tensor,     # (N,) scale-invariance range
    pt_max_dist: torch.Tensor,
    pt_valid: torch.Tensor,
    T_cw: torch.Tensor,
    fx, fy, cx, cy, bf,
    img_w, img_h,
    scale_factors: torch.Tensor,   # (L,)
    log_scale: torch.Tensor,       # 0-d log(scaleFactor)
    th: torch.Tensor,
    nn_ratio: torch.Tensor,        # mfNNratio (0.8 in TrackLocalMap)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SearchLocalPoints core: frustum check + windowed best/second-best
    matching. Returns (assign (M,) int32, n_matches)."""
    n_levels = scale_factors.shape[0]
    invz, u, v, dist, view_cos, in_frustum = _frustum(
        pt_world, pt_normal, pt_min_dist, pt_max_dist, pt_valid,
        T_cw, fx, fy, cx, cy, img_w, img_h)

    # MapPoint::PredictScale: ceil(log(maxDist / dist) / log(scaleFactor))
    pred = torch.ceil(
        numerics.log(torch.clamp(pt_max_dist / torch.clamp(dist, min=1e-9), min=1e-9))
        / log_scale
    )
    pred = torch.clamp(pred, 0, n_levels - 1).to(torch.int32)

    r = _radius_by_viewing_cos(view_cos) * th * scale_factors[pred]
    du = torch.abs(cur_xy[:, 0][None, :] - u[:, None])
    dv = torch.abs(cur_xy[:, 1][None, :] - v[:, None])
    in_window = (du < r[:, None]) & (dv < r[:, None])

    co = cur_octave[None, :]
    oct_ok = (co >= pred[:, None] - 1) & (co <= pred[:, None] + 1)

    mask = (
        in_frustum[:, None]
        & cur_valid[None, :]
        & (~cur_has_point)[None, :]
        & in_window
        & oct_ok
        & _stereo_ok(u, invz, bf, cur_ur, r)
    )
    masked = torch.where(mask, hamming_matrix(pt_desc, cur_desc), _BIG)

    # best + second best, as lax.top_k(-masked, 2) orders them: the first
    # minimum, then the first minimum of the rest (an all-masked row gives
    # columns 0 and 1)
    best_j = torch.argmin(masked, dim=1)
    best_d = torch.gather(masked, 1, best_j[:, None])[:, 0]
    rest = masked.scatter(1, best_j[:, None], 1 << 30)
    second_j = torch.argmin(rest, dim=1)
    second_d = torch.gather(rest, 1, second_j[:, None])[:, 0]
    same_level = cur_octave[best_j] == cur_octave[second_j]
    ratio_fail = same_level & (
        best_d.to(torch.float32) > nn_ratio * second_d.to(torch.float32)
    )
    point_matched = (best_d <= TH_HIGH) & ~ratio_fail

    assign, _wins = resolve_one_to_one(best_j.to(torch.int32), best_d, point_matched,
                                       cur_xy.shape[0])
    return assign, (assign >= 0).sum(dtype=torch.int32)
