"""Epipolar matching + two-view triangulation for new map points
(ORBmatcher::SearchForTriangulation, ORBmatcher.cc:72 + CheckDistEpipolarLine
146; LocalMapping::CreateNewMapPoints, LocalMapping.cc:273-525).

Port of ``iv_slam_tpu/ops/triangulate.py``. The reference's DBoW2 bucket
pruning is replaced by the dense Hamming matrix under the same geometric
gates (epipolar-line distance, not-yet-matched masks, descriptor
threshold); the triangulation checks (parallax, cheirality, reprojection,
scale consistency) run batched over all accepted pairs.

The checks decide which points a keyframe event creates, so every root,
cosine, arc tangent, division by a constant and small matrix product goes
through ``numerics`` and rounds alike on the CPU and on the GPU. The DLT's
4x4 eigenproblem is solved in float64 (``torch.linalg.eigh``: LAPACK on the
CPU, cuSOLVER on the GPU) and its eigenvector rounded once to float32, so
the two devices agree on the point but for the rare value at a rounding
boundary. The compactions keep row-major order and clamp every gather index
that ``jnp`` would clip.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import numerics
from .hamming import hamming_matrix
from .match import _BIG, compact, resolve_one_to_one

TH_LOW = 50

# accepted (neighbor, feature) pairs per event are O(100); the cap bounds
# the triangulation batch and the download, and an overflow is reported
# by the raw match count, never silent
T_CAP = 2048

# scale-consistency factor 1.5 * scaleFactor (LocalMapping.cc:489-503), as
# the reference's float32 weak-typed constant
_RATIO_FACTOR = float(np.float32(1.5 * 1.2))


def search_for_triangulation(
    xy1: torch.Tensor, desc1: torch.Tensor, free1: torch.Tensor,
    xy2: torch.Tensor, desc2: torch.Tensor, free2: torch.Tensor,
    F12: torch.Tensor,
    sigma2_2: torch.Tensor,        # (NB, N2) level variance of the neighbors' keypoints
    epipole2: torch.Tensor,        # (NB, 2) projection of cam1's center in each neighbor
    ex_check: torch.Tensor,        # (NB,) bool: enforce the epipole gate (mono)
    sigma2_1_for_ex: torch.Tensor,  # (NB, N2) scale^2 for the epipole gate
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Matches the free features of kf1 to those of each of NB neighbors
    under the epipolar constraint: the reference's search_for_triangulation
    vmapped over the neighbor axis (search_for_triangulation_batched), so
    the neighbors' arrays carry a leading (NB, ...) axis. Returns
    (assign (NB, N1) int32, n (NB,))."""
    n2 = xy2.shape[1]
    dist = hamming_matrix(desc1, desc2)                                  # (NB, N1, N2)
    # epipolar line of x1 in image 2: l2 = x1^T F12 (ORBmatcher.cc:146)
    x1h = torch.cat([xy1, torch.ones_like(xy1[:, :1])], dim=1)          # (N1, 3)
    l2 = numerics.matmul(x1h[None], F12)                                 # (NB, N1, 3)
    x2h = torch.cat([xy2, torch.ones_like(xy2[..., :1])], dim=-1)       # (NB, N2, 3)
    num = numerics.matmul(l2, x2h.transpose(-1, -2)) ** 2               # (NB, N1, N2)
    den = l2[..., 0:1] ** 2 + l2[..., 1:2] ** 2
    dsqr = num / torch.clamp(den, min=1e-12)
    epi_ok = dsqr < 3.84 * sigma2_2[:, None, :]
    d = xy2 - epipole2[:, None, :]
    de2 = d[..., 0] ** 2 + d[..., 1] ** 2                               # (NB, N2)
    ex_ok = ~ex_check[:, None] | (de2 >= 100.0 * sigma2_1_for_ex)
    mask = free1[None, :, None] & free2[:, None, :] & epi_ok & ex_ok[:, None, :]
    masked = torch.where(mask, dist, _BIG)
    best_j = torch.argmin(masked, dim=-1).to(torch.int32)               # first minimum
    best_d = torch.gather(masked, -1, best_j[..., None].long())[..., 0]
    ok = best_d < TH_LOW
    wins = torch.stack([resolve_one_to_one(best_j[b], best_d[b], ok[b], n2)[1]
                        for b in range(xy2.shape[0])])
    return torch.where(wins, best_j, -1), wins.sum(dim=1, dtype=torch.int32)


def _einsum_nji_nj(R, t):
    """einsum('nji,nj->ni', R, t): R^T t per row, summed over j in order."""
    return numerics.matmul(R.transpose(-1, -2), t[..., None])[..., 0]


def _norm3(x):
    return numerics.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]
                         + x[..., 2] * x[..., 2])


def triangulate_checked(
    xy1: torch.Tensor, xy2: torch.Tensor,       # (N, 2) matched pixels
    ur1: torch.Tensor, depth1: torch.Tensor,    # stereo data of kf1 features
    ur2: torch.Tensor, depth2: torch.Tensor,
    sigma2_1: torch.Tensor, sigma2_2: torch.Tensor,
    scale1: torch.Tensor, scale2: torch.Tensor,  # scaleFactor^octave per feature
    valid: torch.Tensor,
    T1w: torch.Tensor, T2w: torch.Tensor,        # (4, 4) / (N, 4, 4) poses
    fx, fy, cx, cy, bf,                          # 0-d float32 tensors
) -> Tuple[torch.Tensor, torch.Tensor]:
    """LocalMapping::CreateNewMapPoints triangulation core: DLT when the
    parallax allows, stereo back-projection otherwise, then the full check
    battery. Returns (points_w (N, 3), good (N,))."""
    n = xy1.shape[0]
    if T2w.dim() == 2:
        T2w = T2w.expand(n, 4, 4)
    R1, t1 = T1w[:3, :3], T1w[:3, 3]
    R2, t2 = T2w[:, :3, :3], T2w[:, :3, 3]
    O1 = -numerics.matmul(R1.T, t1[:, None])[:, 0]
    O2 = -_einsum_nji_nj(R2, t2)

    one = torch.ones_like(xy1[:, 0])
    xn1 = torch.stack([(xy1[:, 0] - cx) / fx, (xy1[:, 1] - cy) / fy, one], dim=1)
    xn2 = torch.stack([(xy2[:, 0] - cx) / fx, (xy2[:, 1] - cy) / fy, one], dim=1)
    ray1 = numerics.matmul(xn1, R1)                  # world-frame rays (R^T xn)
    ray2 = numerics.matmul(xn2[:, None, :], R2)[:, 0]
    cos_par = (ray1[:, 0] * ray2[:, 0] + ray1[:, 1] * ray2[:, 1] + ray1[:, 2] * ray2[:, 2]) \
        / torch.clamp(_norm3(ray1) * _norm3(ray2), min=1e-12)
    # stereo parallax (LocalMapping.cc:373-382)
    half_b = bf / fx / 2.0   # / 2 is exact, as in the reference

    def stereo_cos(depth):
        return torch.where(depth > 0, numerics.cos(2.0 * numerics.atan2(
            half_b.expand_as(depth), depth)), 1e9)

    cos_stereo1, cos_stereo2 = stereo_cos(depth1), stereo_cos(depth2)
    cos_stereo = torch.minimum(cos_stereo1, cos_stereo2)

    # DLT: the null space of A is the eigenvector of A^T A at the smallest
    # eigenvalue (ascending order, as jnp.linalg.eigh), the subspace of the
    # smallest right-singular vector the reference takes from cv::SVD
    # (LocalMapping.cc:397); its sign cancels in X[:3] / X[3]
    P1 = torch.cat([R1, t1[:, None]], dim=1)                   # (3, 4)
    P2 = torch.cat([R2, t2[..., None]], dim=2)                 # (N, 3, 4)
    A = torch.stack([
        xn1[:, 0:1] * P1[2] - P1[0],
        xn1[:, 1:2] * P1[2] - P1[1],
        xn2[:, 0:1] * P2[:, 2] - P2[:, 0],
        xn2[:, 1:2] * P2[:, 2] - P2[:, 1],
    ], dim=1).double()                                         # (N, 4, 4)
    _w, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    Xh = V[:, :, 0].float()
    X_dlt = Xh[:, :3] / torch.where(Xh[:, 3:].abs() > 1e-12, Xh[:, 3:], 1e-12)

    # stereo back-projection fallbacks
    xc1 = torch.stack([(xy1[:, 0] - cx) * depth1 / fx, (xy1[:, 1] - cy) * depth1 / fy,
                       depth1], dim=1)
    Twc1 = numerics.rounded(torch.linalg.inv, T1w)
    X_s1 = numerics.matmul(xc1, Twc1[:3, :3].T) + Twc1[:3, 3]
    xc2 = torch.stack([(xy2[:, 0] - cx) * depth2 / fx, (xy2[:, 1] - cy) * depth2 / fy,
                       depth2], dim=1)
    # camera -> world without a batched 4x4 inverse: X = R^T (xc - t)
    X_s2 = _einsum_nji_nj(R2, xc2 - t2)

    use_dlt = (cos_par < torch.clamp(cos_stereo, max=0.9998)) & (cos_par > 0)
    use_s1 = ~use_dlt & (depth1 > 0) & (cos_stereo1 <= cos_stereo2)
    use_s2 = ~use_dlt & ~use_s1 & (depth2 > 0)
    X = torch.where(use_dlt[:, None], X_dlt, torch.where(use_s1[:, None], X_s1, X_s2))
    has_source = use_dlt | use_s1 | use_s2

    def checks(pc, xy, ur, sig2):
        z = pc[:, 2]
        zc = torch.clamp(z, min=1e-9)
        u = fx * pc[:, 0] / zc + cx
        v = fy * pc[:, 1] / zc + cy
        e2 = (u - xy[:, 0]) ** 2 + (v - xy[:, 1]) ** 2
        ur_pred = u - bf / zc
        e2_st = e2 + torch.where(ur > 0, (ur_pred - ur) ** 2, 0.0)
        th = torch.where(ur > 0, 7.8, 5.991) * sig2
        return (z > 0) & (e2_st < th)

    ok1 = checks(numerics.matmul(X, R1.T) + t1, xy1, ur1, sigma2_1)
    ok2 = checks(numerics.matmul(R2, X[..., None])[..., 0] + t2, xy2, ur2, sigma2_2)

    # scale consistency (LocalMapping.cc:489-503)
    d1 = _norm3(X - O1[None])
    d2 = _norm3(X - O2)
    ratio_dist = d2 / torch.clamp(d1, min=1e-12)
    ratio_oct = scale1 / torch.clamp(scale2, min=1e-12)
    scale_ok = ((ratio_dist <= ratio_oct * _RATIO_FACTOR)
                & (ratio_dist >= numerics.div(ratio_oct, _RATIO_FACTOR)))

    good = (valid & has_source & torch.isfinite(X).all(dim=1)
            & ok1 & ok2 & scale_ok & (d1 > 0) & (d2 > 0))
    return X, good


def triangulate_event_compact(
    xy1, desc1, free1, ur1, depth1, oct1,
    xy2_nb, desc2_nb, free2_nb, ur2_nb, depth2_nb, oct2_nb,
    F12_nb, epipole2_nb, ex_check_nb,
    T1w, T2w_nb, scale_factors,
    fx, fy, cx, cy, bf,
) -> torch.Tensor:
    """One keyframe's triangulation against NB neighbors: the batched
    epipolar search, then triangulation of the accepted pairs compacted
    BEFORE the DLT (only O(100) of the NB*N1 pairs match), then a second
    compaction of the pairs that triangulated. Rows keep (neighbor-major,
    feature) order. Returns a flat (T_CAP*6 + 2,) float32 tensor: (T_CAP, 6)
    rows [nb_i, f1, f2, X_world], then [accepted count, raw epipolar-match
    count] (the caller reports a count above T_CAP).

    Takes per-keypoint octaves and derives sigma^2 and scale on the device,
    as the reference does."""
    sf = scale_factors
    scale1 = sf[oct1]
    sig2_1 = scale1 * scale1
    scale2_nb = sf[oct2_nb]
    sig2_2_nb = scale2_nb * scale2_nb
    assign, _ = search_for_triangulation(
        xy1, desc1, free1, xy2_nb, desc2_nb, free2_nb, F12_nb,
        sig2_2_nb, epipole2_nb, ex_check_nb, sig2_2_nb)                # (NB, N1)
    n1 = assign.shape[1]
    f32 = torch.float32

    matched = (assign >= 0).reshape(-1)
    sel, pair_valid, cum = compact(matched, T_CAP)
    nbi = (sel // n1).long()
    f1 = (sel % n1).long()
    f2 = assign[nbi, f1]                                                # (T_CAP,)
    j2 = torch.clamp(f2, min=0).long()

    X, good = triangulate_checked(
        xy1[f1], xy2_nb[nbi, j2],
        ur1[f1], depth1[f1],
        ur2_nb[nbi, j2], depth2_nb[nbi, j2],
        sig2_1[f1], sig2_2_nb[nbi, j2],
        scale1[f1], scale2_nb[nbi, j2],
        pair_valid,
        T1w, T2w_nb[nbi], fx, fy, cx, cy, bf)

    rows = torch.stack([nbi.to(f32), f1.to(f32), f2.to(f32), X[:, 0], X[:, 1], X[:, 2]],
                       dim=1)                                           # (T_CAP, 6)
    sel2, slot_ok2, cum2 = compact(good, T_CAP)
    out = torch.where(slot_ok2[:, None], rows[sel2.long()], 0.0)
    return torch.cat([out.reshape(-1), cum2[-1:].to(f32), cum[-1:].to(f32)])
