"""BoW-restricted and Sim3-guided descriptor matching
(ORBmatcher::SearchByBoW, ORBmatcher::SearchBySim3).

Port of ``iv_slam_tpu/ops/bow_match.py``. The reference walks aligned DBoW2
FeatureVector node buckets and compares descriptors only within the same
vocabulary node (ORBmatcher.cc:546-700); the JAX form, kept here, is one
dense Hamming matrix masked by node-id equality, the ratio test, a
one-to-one resolution and the rotation-consistency histogram.

Ties as the reference: the best candidate is the first minimum, the second
distance is the least over the remaining columns (``lax.top_k`` of two);
float comparisons use the reference's float32 operations in its order, and
the predicted pyramid level goes through ``numerics.log``.
"""

from __future__ import annotations

import torch

from .. import numerics
from ..geometry import se3
from .hamming import hamming_matrix
from .match import resolve_one_to_one, rotation_consistency_mask

TH_LOW = 50
TH_HIGH = 100
_BIG = 1 << 20


def search_by_bow(
    desc_a: torch.Tensor,     # (N, 32) keyframe descriptors
    node_a: torch.Tensor,     # (N,) vocabulary node (at levels_up) per feature
    angle_a: torch.Tensor,    # (N,)
    valid_a: torch.Tensor,    # (N,) bool (feature has a map point)
    desc_b: torch.Tensor,     # (M, 32) frame/keyframe descriptors
    node_b: torch.Tensor,     # (M,)
    angle_b: torch.Tensor,
    valid_b: torch.Tensor,
    nn_ratio: torch.Tensor,   # 0-d float32: mfNNratio (0.75 loop closing, 0.7 reloc)
    check_orientation: bool = True,
):
    """Returns (assign (N,) int32, n): assign[i] = matched index in b for
    feature i of a, or -1. Matching runs from a's features (map points)
    to b's keypoints."""
    dist = hamming_matrix(desc_a, desc_b)
    mask = (node_a[:, None] == node_b[None, :]) & valid_a[:, None] & valid_b[None, :]
    masked = torch.where(mask, dist, _BIG)
    best_j = torch.argmin(masked, dim=1)                        # first minimum
    best_d = torch.gather(masked, 1, best_j[:, None])[:, 0]
    cols = torch.arange(masked.shape[1], device=masked.device)
    second_d = torch.where(cols[None, :] == best_j[:, None], torch.iinfo(torch.int32).max,
                           masked).amin(dim=1)
    ok = (best_d <= TH_LOW) & (best_d.to(torch.float32)
                               < nn_ratio * second_d.to(torch.float32))
    _b_assign, wins = resolve_one_to_one(best_j.to(torch.int32), best_d, ok,
                                         desc_b.shape[0])
    assign = torch.where(wins, best_j.to(torch.int32), -1)
    if check_orientation:
        safe = torch.clamp(assign, min=0).long()
        keep = rotation_consistency_mask(angle_a, angle_b[safe], assign >= 0)
        assign = torch.where(keep, assign, -1)
    return assign, (assign >= 0).sum(dtype=torch.int32)


def _project_side(P_src, sR, t, xy_dst, oct_dst, valid_dst, max_dist_src,
                  fx, fy, cx, cy, scale_factors, log_scale, th):
    """(N_src, N_dst) window mask: each source point through (sR, t) into
    the destination image, searched at its predicted level +-1."""
    n_levels = scale_factors.shape[0]
    pc = numerics.matmul(P_src, sR.transpose(0, 1)) + t
    z = pc[:, 2]
    invz = 1.0 / torch.where(z != 0, z, 1.0)
    u = fx * pc[:, 0] * invz + cx
    v = fy * pc[:, 1] * invz + cy
    ok = z > 0
    dist = numerics.sqrt(se3.sum3(pc, pc))
    pred = torch.ceil(numerics.log(torch.clamp(max_dist_src / torch.clamp(dist, min=1e-9),
                                               min=1e-9)) / log_scale)
    pred = torch.clamp(pred, 0, n_levels - 1).to(torch.int32)
    r = th * scale_factors[pred.long()]
    du = torch.abs(xy_dst[None, :, 0] - u[:, None])
    dv = torch.abs(xy_dst[None, :, 1] - v[:, None])
    window = (du < r[:, None]) & (dv < r[:, None])
    oct_ok = (oct_dst[None, :] >= pred[:, None] - 1) & (oct_dst[None, :] <= pred[:, None] + 1)
    return ok[:, None] & window & oct_ok & valid_dst[None, :]


def search_by_sim3(
    # KF1 map points in KF1 camera coordinates + their keypoint data
    P1, desc1, xy1, oct1, valid1,
    # KF2
    P2, desc2, xy2, oct2, valid2,
    # Sim3 S12 (KF2-cam -> KF1-cam) as a scaled rotation + translation
    sR12, t12,
    fx, fy, cx, cy,              # 0-d float32 tensors
    scale_factors, log_scale,
    max_dist1, max_dist2,        # (N1,), (N2,) mfMaxDistance per point
    th=7.5,
):
    """ORBmatcher::SearchBySim3 (1146-1300 semantics): project each side's
    map points into the other through S12 / S12^-1, window-search at the
    predicted scale, and keep mutually agreeing pairs. Returns
    (assign12 (N1,) int32: KF2 feature per KF1 feature or -1, n)."""
    # S21 = S12^-1: x1 -> x2
    s2 = sR12[0, 0] * sR12[0, 0] + sR12[0, 1] * sR12[0, 1] + sR12[0, 2] * sR12[0, 2]
    sR21 = sR12.transpose(0, 1) / s2
    t21 = -numerics.matmul(sR21, t12[:, None])[:, 0]
    common = (fx, fy, cx, cy, scale_factors, log_scale, th)
    mask12 = _project_side(P1, sR21, t21, xy2, oct2, valid2, max_dist1, *common)
    mask21 = _project_side(P2, sR12, t12, xy1, oct1, valid1, max_dist2, *common)
    mask = mask12 & mask21.transpose(0, 1) & valid1[:, None]
    masked = torch.where(mask, hamming_matrix(desc1, desc2), _BIG)
    best12 = torch.argmin(masked, dim=1)
    d12 = torch.gather(masked, 1, best12[:, None])[:, 0]
    best21 = torch.argmin(masked, dim=0)
    mutual = best21[best12] == torch.arange(P1.shape[0], device=P1.device)
    ok = (d12 <= TH_HIGH) & mutual
    return torch.where(ok, best12.to(torch.int32), -1), ok.sum(dtype=torch.int32)
