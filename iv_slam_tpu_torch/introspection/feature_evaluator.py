"""Supervised feature scoring: uncertainty-normalized epipolar error.

Port of ``iv_slam_tpu/introspection/feature_evaluator.py``, the heart of
IV-SLAM's training-data generation (src/feature_evaluator.cpp:1341-1512,
2754-2830): each matched keypoint pair (reference-keyframe observation,
current-frame observation) is scored by the current keypoint's pixel
distance to its epipolar line, computed from the ground-truth relative
pose, normalized by a first-order propagation of pose and keypoint-scale
uncertainty through the epipolar geometry. The whole frame's pairs are one
batched computation of small-matrix algebra on the device; products of the
3x3 matrices and the square roots go through numerics.py, so the card and
the CPU round alike.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import numerics

MIN_BASELINE = 0.03                  # kMinBaseLine (meters)
MIN_SENSITIVITY = 1.0                # kMinEpipolarErrSensitivity_
NO_COV_NORMALIZATION = 4.0           # kNormalizationFactor (no-cov case)
SCALE95 = 2.4477  # sqrt(5.991)
BAD_ERR_THRESH = 1.0                 # kBadFeatureErrThresh_Epipolar_
BAD_ERR_THRESH_REPROJ = 5.0          # kBadFeatureErrThresh_Reproj_ (.h:331)

# TrainingMode enum (feature_evaluator.h:68-78) -> (reference source,
# error type). The reference LOG(FATAL)s on the two *_last_kf modes
# (fe.cpp:2151-2160, 2206-2209); they raise NotImplementedError here.
TRAINING_MODES = {
    "prev_frame": ("prev", "reproj"),
    "prev_frame_and_last_kf": None,                 # kCompareAgainstPrevFrameAndLastKeyFrame
    "prev_frame_and_ref_kf": ("prev_and_ref", "reproj"),
    "last_kf": None,                                # kCompareAgainstLastKeyFrame
    "ref_kf": ("ref", "reproj"),
    "prev_frame_epipolar": ("prev", "epipolar"),
    "ref_kf_epipolar": ("ref", "epipolar"),
    "prev_frame_epipolar_normalized": ("prev", "epipolar_normalized"),
    "ref_kf_epipolar_normalized": ("ref", "epipolar_normalized"),
}
MIN_BAD_PERCENT = 5.0                # kMinBadMatchPercent_
MAX_BAD_PERCENT = 60.0               # kMaxBadMatchPercent_
MIN_MATCHES = 10                     # kMinMatchesInFrame_


class EpipolarScores(NamedTuple):
    norm_err: torch.Tensor   # (N,) normalized epipolar error; -1 = invalid
    raw_err: torch.Tensor    # (N,) pixel distance to the epipolar line
    variance: torch.Tensor   # (N,) propagated error variance
    foot: torch.Tensor       # (N, 2) perpendicular foot on the epipolar line
                             # (epipolar_projections_, fe.cpp:2785-2815)


def _hat(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
    ], dim=-2)


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, squares summed left to right."""
    s = v[..., 0] * v[..., 0]
    for i in range(1, v.shape[-1]):
        s = s + v[..., i] * v[..., i]
    return numerics.sqrt(s)


def _quad(J: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """J_n^T S J_n for (N, 3) rows J and a 3x3 S."""
    return (numerics.matmul(J[:, None, :], S)[:, 0] * J).sum(dim=-1)


def epipolar_scores(
    kp_ref: torch.Tensor,       # (N, 2) keypoints in the reference frame
    kp_cur: torch.Tensor,       # (N, 2) matched keypoints in the current frame
    level_sigma2: torch.Tensor,  # (N,) keypoint scale variance (curr octave)
    valid: torch.Tensor,        # (N,) bool
    T_rel: torch.Tensor,        # (4, 4) or (N, 4, 4) ref-cam -> curr-cam GT
                                # transform, per keypoint when batched (each
                                # map point's own reference keyframe)
    Kmat: torch.Tensor,         # (3, 3) intrinsics
    sigma_w: torch.Tensor,      # (3, 3) rotational covariance of T_rel
    sigma_t: torch.Tensor,      # (3, 3) translational covariance of T_rel
    has_cov: torch.Tensor,      # () bool
) -> EpipolarScores:
    n = kp_ref.shape[0]
    if T_rel.ndim == 2:
        T_rel = T_rel.expand(n, 4, 4)
    R = T_rel[:, :3, :3]                             # (N, 3, 3)
    t = T_rel[:, :3, 3]                              # (N, 3)
    fx, fy = Kmat[0, 0], Kmat[1, 1]
    cx, cy = Kmat[0, 2], Kmat[1, 2]
    baseline_ok = _norm(t) >= MIN_BASELINE

    # normalized ref points K^-1 [u, v, 1]; the epipolar line l = F p_ref
    # with F = [K t]x (K R K^-1) (GetEpipolarErrorJacobians): the
    # point-to-line distance |x^T l| / |l_12| stays defined when the
    # epipole is at infinity, where the reference's parameterization
    # through the epipole divides by t_z
    xr = torch.stack([(kp_ref[:, 0] - cx) / fx, (kp_ref[:, 1] - cy) / fy,
                      torch.ones_like(kp_ref[:, 0])], dim=-1)
    B = numerics.matmul(numerics.matmul(Kmat[None], R), xr[..., None])   # (N, 3, 1)
    KT = numerics.matmul(t[:, None, :], Kmat.T[None])[:, 0]              # (N, 3) = K t
    l = numerics.matmul(_hat(KT), B)[..., 0]                            # (N, 3)
    Ln = torch.clamp(_norm(l[:, :2]), min=1e-12)
    L3 = Ln ** 3

    # Jl_t: column i = K[:, i] x B  (GetEpipolarLineJacobians)
    Jl_t = torch.stack([torch.linalg.cross(Kmat[:, i][None, :].expand(n, 3), B[..., 0])
                        for i in range(3)], dim=-1)                     # (N, 3, 3)
    C = numerics.matmul(R, xr[..., None])
    Jl_w = -numerics.matmul(_hat(KT), numerics.matmul(Kmat[None], _hat(C[..., 0])))

    xn = torch.cat([kp_cur, torch.ones_like(kp_cur[:, :1])], dim=-1)
    xl = (xn * l).sum(dim=-1)                        # x^T l
    raw_err = torch.abs(xl) / Ln                     # distance to the epipolar line

    def err_jac(Jl):
        term1 = numerics.matmul(xn[:, None, :], Jl)[:, 0] / Ln[:, None]
        term2 = (xl[:, None] * (l[:, 0:1] * Jl[:, 0, :] + l[:, 1:2] * Jl[:, 1, :])
                 / L3[:, None])
        return term1 - term2  # (N, 3)

    J_t = err_jac(Jl_t)
    J_w = err_jac(Jl_w)
    var = _quad(J_w, sigma_w) + _quad(J_t, sigma_t) + level_sigma2

    norm = SCALE95 * numerics.sqrt(torch.clamp(var, min=0.0))
    norm = torch.where(has_cov, norm, norm * NO_COV_NORMALIZATION)
    norm = torch.clamp(norm, min=MIN_SENSITIVITY)

    ok = valid & baseline_ok
    norm_err = torch.where(ok, raw_err / norm, -1.0)
    # perpendicular foot of the current keypoint on the epipolar line
    Ln2 = torch.clamp(l[:, 0] ** 2 + l[:, 1] ** 2, min=1e-12)
    foot = kp_cur - (xl / Ln2)[:, None] * l[:, :2]
    return EpipolarScores(norm_err=norm_err, raw_err=torch.where(ok, raw_err, -1.0),
                          variance=torch.where(ok, var, -1.0), foot=foot)


def relative_transform(Twc_cur: torch.Tensor, Twc_ref: torch.Tensor) -> torch.Tensor:
    """ref-camera -> current-camera transform from GT camera-to-world poses
    (CalculateRelativeTransform, fe.cpp:3214-3217)."""
    R = Twc_cur[:3, :3]
    t = Twc_cur[:3, 3]
    Tcw = torch.zeros((4, 4), dtype=Twc_cur.dtype, device=Twc_cur.device)
    Tcw[:3, :3] = R.T
    Tcw[:3, 3] = -numerics.matmul(R.T, t[:, None])[:, 0]
    Tcw[3, 3] = 1.0
    return numerics.matmul(Tcw, Twc_ref)


def _pixel_err(p_cur, kp_cur, Kmat):
    """Projection of camera points (N, 3) and its distance to kp_cur."""
    fx, fy = Kmat[0, 0], Kmat[1, 1]
    cx, cy = Kmat[0, 2], Kmat[1, 2]
    zc = p_cur[:, 2]
    zs = torch.where(zc != 0, zc, torch.ones_like(zc))
    u = fx * p_cur[:, 0] / zs + cx
    v = fy * p_cur[:, 1] / zs + cy
    du, dv = u - kp_cur[:, 0], v - kp_cur[:, 1]
    return numerics.sqrt(du * du + dv * dv), zc, u, v


def gt_reprojection_errors(
    kp_ref: torch.Tensor,       # (N, 2) reference-frame keypoints
    kp_cur: torch.Tensor,       # (N, 2) matched current-frame keypoints
    gt_depth_ref: torch.Tensor,  # (N,) GT depth at the reference keypoints
    valid: torch.Tensor,
    T_rel: torch.Tensor,        # (4, 4) ref-cam -> cur-cam GT transform
    Kmat: torch.Tensor,
) -> torch.Tensor:
    """Reprojection-based scoring (ErrorType::kReprojection;
    FeatureEvaluator::GetGTReprojection, fe.cpp:1186-1340): backproject the
    reference keypoint with its ground-truth depth, transform with the GT
    relative pose, and measure the pixel distance to the matched current
    keypoint. -1 where invalid (no GT depth)."""
    fx, fy = Kmat[0, 0], Kmat[1, 1]
    cx, cy = Kmat[0, 2], Kmat[1, 2]
    z = gt_depth_ref
    p_ref = torch.stack([(kp_ref[:, 0] - cx) * z / fx, (kp_ref[:, 1] - cy) * z / fy, z],
                        dim=-1)
    p_cur = numerics.matmul(p_ref, T_rel[:3, :3].T) + T_rel[:3, 3]
    err, zc, _, _ = _pixel_err(p_cur, kp_cur, Kmat)
    return torch.where(valid & (z > 0) & (zc > 0), err, -1.0)


def map_point_reprojection_errors(
    kp_cur: torch.Tensor,     # (N, 2) current-frame keypoints
    pt_world: torch.Tensor,   # (N, 3) matched map-point world positions
    T_ref_cw: torch.Tensor,   # (N, 4, 4) reference frame ESTIMATED Tcw
    T_rel_gt: torch.Tensor,   # (N, 4, 4) GT ref-cam -> cur-cam transform
    valid: torch.Tensor,
    Kmat: torch.Tensor,
):
    """Reprojection scoring of the non-epipolar training modes
    (CalculateReprojectionError, fe.cpp:2979-3074): the map point's
    position in the reference camera carried over by the GT relative
    transform, X_cur = T_gt(ref->cur) . Tcw_ref . X_w, projected and
    compared with the observed keypoint. Returns (errors (N,), -1 where
    invalid; projections (N, 2))."""
    ph = torch.cat([pt_world, torch.ones_like(pt_world[:, :1])], dim=-1)
    p_ref = numerics.matmul(T_ref_cw, ph[..., None])
    p_cur = numerics.matmul(T_rel_gt, p_ref)[:, :3, 0]
    err, zc, u, v = _pixel_err(p_cur, kp_cur, Kmat)
    return torch.where(valid & (zc != 0), err, -1.0), torch.stack([u, v], dim=-1)


def rel_pose_cov_from_uncertainty(unc, ref_id: int, cur_id: int):
    """Per-frame-pair pose covariance from a loaded uncertainty table
    (GetRelativePoseUncertainty, fe.cpp:2008-2063): the max translational /
    rotational uncertainty over the frame range, scaled by 1/4.0 and 1/0.1,
    as isotropic covariances from the 95% bounds.
    unc: (N, 2) rows of (translational_unc, rotational_unc).
    Returns (sigma_w (3,3), sigma_t (3,3)) float64, or None out of range."""
    lo, hi = min(ref_id, cur_id), max(ref_id, cur_id)
    if lo < 0 or hi >= len(unc):
        return None
    seg = np.asarray(unc[lo:hi + 1], np.float64)
    max_trans = float(seg[:, 0].max()) / 4.0    # tran_unc_scalar
    max_rot = float(seg[:, 1].max()) / 0.1      # rot_unc_scalar
    s_t = (max_trans / SCALE95) ** 2
    s_w = (max_rot / (SCALE95 * np.sqrt(3.0))) ** 2
    return s_w * np.eye(3), s_t * np.eye(3)


def bad_match_stats(norm_err: torch.Tensor, thresh: float = BAD_ERR_THRESH):
    """Share of scored matches above kBadFeatureErrThresh (fe.cpp:82-248)
    -> (bad_percent, n_scored) as 0-d tensors. thresh: 1.0 for the
    epipolar error types, 5.0 for reprojection."""
    scored = norm_err >= 0
    n = scored.sum(dtype=torch.int32)
    bad = (scored & (norm_err > thresh)).sum(dtype=torch.int32)
    return 100.0 * bad / torch.clamp(n, min=1), n


def frame_good_for_training(bad_percent: float, n_scored: int) -> bool:
    """IsFrameGoodForTraining (fe.cpp:1978-1994), Unknown-reliability path."""
    return MIN_BAD_PERCENT < bad_percent < MAX_BAD_PERCENT and n_scored > MIN_MATCHES
