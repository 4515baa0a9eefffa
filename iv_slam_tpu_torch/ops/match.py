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

  * fuse_into_keyframes (+ the _compact and _compact_indexed forms):
    ORBmatcher::Fuse batched over target keyframes and points, the
    projection pass of LocalMapping::SearchInNeighbors
  * search_for_initialization: the level-0 windowed search of the
    monocular initializer (ORBmatcher::SearchForInitialization)
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


def compact(mask: torch.Tensor, cap: int):
    """The first `cap` set positions of a (P,) mask, in order, by k-th-set-bit
    search over the inclusive prefix count (no scatter, no host sync).

    Returns (sel (cap,) int32 positions clamped to P-1, sel_ok (cap,) bool
    for the rows that hold a set position, cum (P,) int32 prefix count)."""
    P = mask.shape[0]
    cum = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32)
    want = torch.arange(1, cap + 1, dtype=torch.int32, device=mask.device)
    sel = torch.searchsorted(cum, want, side="left", out_int32=True)
    sel = torch.clamp(sel, max=P - 1)
    sel_ok = torch.arange(cap, device=mask.device) < cum[-1]
    return sel, sel_ok, cum


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


def _best_two(masked: torch.Tensor):
    """Best and second-best column of each row, as ``lax.top_k(-masked, 2)``
    orders them: the first minimum, then the first minimum of the rest (an
    all-masked row gives columns 0 and 1). Returns (best_j, best_d,
    second_j, second_d), the indices int64."""
    best_j = torch.argmin(masked, dim=1)
    best_d = torch.gather(masked, 1, best_j[:, None])[:, 0]
    rest = masked.scatter(1, best_j[:, None], 1 << 30)
    second_j = torch.argmin(rest, dim=1)
    second_d = torch.gather(rest, 1, second_j[:, None])[:, 0]
    return best_j, best_d, second_j, second_d


def search_for_initialization(
    xy1: torch.Tensor,      # (N, 2) frame-1 keypoints
    oct1: torch.Tensor,
    angle1: torch.Tensor,
    desc1: torch.Tensor,
    valid1: torch.Tensor,
    xy2: torch.Tensor,      # (M, 2) frame-2 keypoints
    oct2: torch.Tensor,
    angle2: torch.Tensor,
    desc2: torch.Tensor,
    valid2: torch.Tensor,
    prev_xy: torch.Tensor,  # (N, 2) predicted positions in frame 2
    window: torch.Tensor,   # search radius (reference: 100)
    nn_ratio: torch.Tensor,  # 0.9 in MonocularInitialization
    check_orientation: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ORBmatcher::SearchForInitialization (ORBmatcher.cc:69 semantics):
    level-0-only windowed search with best/second ratio and rotation
    histogram. Returns (assign (N,) int32, n): frame-2 index per frame-1
    keypoint, or -1."""
    du = torch.abs(xy2[None, :, 0] - prev_xy[:, None, 0])
    dv = torch.abs(xy2[None, :, 1] - prev_xy[:, None, 1])
    mask = ((du < window) & (dv < window)
            & (oct1[:, None] == 0) & (oct2[None, :] == 0)
            & valid1[:, None] & valid2[None, :])
    masked = torch.where(mask, hamming_matrix(desc1, desc2), _BIG)
    best_j, best_d, _second_j, second_d = _best_two(masked)
    ok = (best_d <= TH_LOW) & (
        best_d.to(torch.float32) < nn_ratio * second_d.to(torch.float32))
    # one-to-one resolution by lowest distance
    best_j = best_j.to(torch.int32)
    _assign, wins = resolve_one_to_one(best_j, best_d, ok, xy2.shape[0])
    assign = torch.where(wins, best_j, -1)
    if check_orientation:
        safe = torch.clamp(assign, min=0).long()
        keep = rotation_consistency_mask(angle1, angle2[safe], assign >= 0)
        assign = torch.where(keep, assign, -1)
    return assign, (assign >= 0).sum(dtype=torch.int32)


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

    best_j, best_d, second_j, second_d = _best_two(masked)
    same_level = cur_octave[best_j] == cur_octave[second_j]
    ratio_fail = same_level & (
        best_d.to(torch.float32) > nn_ratio * second_d.to(torch.float32)
    )
    point_matched = (best_d <= TH_HIGH) & ~ratio_fail

    assign, _wins = resolve_one_to_one(best_j.to(torch.int32), best_d, point_matched,
                                       cur_xy.shape[0])
    return assign, (assign >= 0).sum(dtype=torch.int32)


def fuse_into_keyframes(
    # target keyframes, stacked (NB, ...)
    kf_xy: torch.Tensor,        # (NB, N, 2)
    kf_oct: torch.Tensor,       # (NB, N)
    kf_desc: torch.Tensor,      # (NB, N, 32)
    kf_valid: torch.Tensor,     # (NB, N)
    kf_ur: torch.Tensor,        # (NB, N) mvuRight; < 0 = mono keypoint
    kf_T: torch.Tensor,         # (NB, 4, 4) Tcw
    # candidate map points (P, ...)
    pt_pos, pt_desc, pt_normal, pt_mind, pt_maxd,
    pt_mask_nb: torch.Tensor,   # (NB, P) point eligible for this target
    scale_factors: torch.Tensor,
    log_scale: torch.Tensor,
    fx, fy, cx, cy, width, height, bf,   # 0-d float32 tensors
    radius_th: torch.Tensor,    # 3.0 (ORBmatcher::Fuse th) / 4.0 (Scw)
    scw: bool = False,
) -> torch.Tensor:
    """ORBmatcher::Fuse over every (target, point): the best matching
    feature per (target, point) or -1, (NB, P) int32. The host applies the
    add-observation / MapPoint::Replace bookkeeping.

    Gating as the reference (ORBmatcher.cc:831-981): the distance gate on
    0.8 minD / 1.2 maxD, the octave window kpLevel in [pred-1, pred], and
    a per-candidate reprojection gate before the Hamming argmin: stereo
    keypoints (u_right >= 0) (ex^2+ey^2+er^2)/sigma^2 <= 7.8 with er
    against the point's virtual right coordinate u - bf/z, mono ones
    (ex^2+ey^2)/sigma^2 <= 5.99. ``scw=True`` is the loop-closing variant
    (ORBmatcher.cc:983-1106): no reprojection gate."""
    sf = scale_factors
    inv_sigma2 = torch.reciprocal(sf * sf)
    n_levels = sf.shape[0]
    R = kf_T[:, :3, :3]
    O = -numerics.matmul(R.transpose(-1, -2), kf_T[:, :3, 3:4])[..., 0]   # (NB, 3)
    pc = se3.transform_points(kf_T, pt_pos)                               # (NB, P, 3)
    z = pc[..., 2]
    zs = torch.clamp(z, min=1e-9)
    u = fx * pc[..., 0] / zs + cx
    v = fy * pc[..., 1] / zs + cy
    diff = pt_pos[None] - O[:, None, :]
    dist = numerics.sqrt(se3.sum3(diff, diff))
    vcos = se3.sum3(diff, pt_normal[None]) / torch.clamp(dist, min=1e-9)
    visible = ((z > 0) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
               & (dist >= 0.8 * pt_mind) & (dist <= 1.2 * pt_maxd)
               & (vcos >= 0.5) & pt_mask_nb)
    pred = torch.ceil(
        numerics.log(torch.clamp(pt_maxd / torch.clamp(dist, min=1e-9), min=1e-9))
        / log_scale)
    pred = torch.clamp(pred, 0, n_levels - 1).to(torch.int32)          # (NB, P)
    r = (radius_th * sf[pred])[..., None]                               # (NB, P, 1)
    ex = kf_xy[:, None, :, 0] - u[..., None]                            # (NB, P, N)
    ey = kf_xy[:, None, :, 1] - v[..., None]
    d_oct = kf_oct[:, None, :] - pred[..., None]
    in_win = ((torch.abs(ex) < r) & (torch.abs(ey) < r) & (d_oct >= -1) & (d_oct <= 0)
              & kf_valid[:, None, :])
    if not scw:
        e2 = ex * ex + ey * ey
        ur_pt = u - bf / zs                                             # virtual u_r
        er = kf_ur[:, None, :] - ur_pt[..., None]
        e2_st = e2 + er * er
        isig = inv_sigma2[kf_oct][:, None, :]                           # (NB, 1, N)
        gate = torch.where(kf_ur[:, None, :] >= 0, e2_st * isig <= 7.8,
                           e2 * isig <= 5.99)
        in_win = in_win & gate
    dmat = hamming_matrix(pt_desc, kf_desc)                             # (NB, P, N)
    masked = torch.where(in_win & visible[..., None], dmat, _BIG)
    best = torch.argmin(masked, dim=-1)                                 # first minimum
    bd = torch.gather(masked, -1, best[..., None])[..., 0]
    return torch.where(bd <= TH_LOW, best.to(torch.int32), -1)


# fused matches per keyframe event are O(1000) (4-6k across 64 targets at
# KITTI scale in the reference's profile): the cap sits above that, and an
# overflow is reported by the count, never silent
F_CAP = 8192


def fuse_into_keyframes_compact(
    kf_xy, kf_oct, kf_desc, kf_valid, kf_ur, kf_T,
    pt_pos, pt_desc, pt_normal, pt_mind, pt_maxd, pt_mask_nb,
    scale_factors, log_scale,
    fx, fy, cx, cy, width, height, bf,
    radius_th,
    scw: bool = False,
) -> torch.Tensor:
    """fuse_into_keyframes with the matches compacted on the device: an
    (F_CAP, 3) table of [target, point, feature] triples in (target-major,
    point) order, then the true count. Returns a flat (F_CAP*3 + 1,)
    float32 tensor (the reference's layout)."""
    assign = fuse_into_keyframes(
        kf_xy, kf_oct, kf_desc, kf_valid, kf_ur, kf_T,
        pt_pos, pt_desc, pt_normal, pt_mind, pt_maxd, pt_mask_nb,
        scale_factors, log_scale, fx, fy, cx, cy, width, height, bf, radius_th,
        scw=scw)                                                         # (NB, P)
    p = assign.shape[1]
    flat = assign.reshape(-1)
    sel, slot_ok, cum = compact(flat >= 0, F_CAP)
    f32 = torch.float32
    rows = torch.stack([(sel // p).to(f32), (sel % p).to(f32), flat[sel.long()].to(f32)],
                       dim=1)
    out = torch.where(slot_ok[:, None], rows, 0.0)
    return torch.cat([out.reshape(-1), cum[-1:].to(f32)])


def fuse_into_keyframes_compact_indexed(
    kf_xy, kf_oct, kf_desc, kf_valid, kf_ur, kf_T,
    kf_ok,                       # (NB,) bool: real (non-padded) targets
    # full-capacity device-map tables (slam/device_map.py full_views)
    map_pos, map_desc, map_normal, map_mind, map_maxd, map_valid,
    pid_idx,                     # (P,) int32 rows of the map; >= capacity = padding
    scale_factors, log_scale,
    fx, fy, cx, cy, width, height, bf,
    radius_th,
    scw: bool = False,
) -> torch.Tensor:
    """fuse_into_keyframes_compact with the candidate point tables gathered
    from the device map by row index (the caller synced the map first), so
    a keyframe event uploads a (P,) index vector instead of the tables.
    Output and semantics as fuse_into_keyframes_compact (point i = row i of
    pid_idx)."""
    cap = map_valid.shape[0]
    pid = torch.clamp(pid_idx, max=cap - 1).long()     # jnp clips the gather
    pt_ok = (pid_idx < cap) & map_valid[pid]
    return fuse_into_keyframes_compact(
        kf_xy, kf_oct, kf_desc, kf_valid, kf_ur, kf_T,
        map_pos[pid], map_desc[pid], map_normal[pid], map_mind[pid], map_maxd[pid],
        kf_ok[:, None] & pt_ok[None, :],
        scale_factors, log_scale, fx, fy, cx, cy, width, height, bf, radius_th,
        scw=scw)
