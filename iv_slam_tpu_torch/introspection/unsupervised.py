"""Unsupervised introspection: chi2-based quality + reliability gating.

A copy of ``iv_slam_tpu/introspection/unsupervised.py`` (host numpy and
scipy, no device work): the unsupervised training-data path
(IVSLAM.unsupervisedLearning):

  * compute_keypt_qual_scores — Frame::ComputeKeyPtQualScores
    (Frame.cc:498-547): map per-edge chi2 (logged by the last pose-LM round)
    through chi-square quantile windows into normalized quality in [-1, 1];
    prune confident short tracks;
  * evaluate_tracking_accuracy — Tracking::EvaluateTrackingAccuracy
    (Tracking.cc:1959-2086): chi2 gate of the estimated relative pose vs
    ground truth over a 20..35-frame horizon plus a minimum-velocity gate;
  * unsup_error_values — GenerateUnsupImageQualityHeatmapGP's input mapping
    err = 2 / (1 + qual) - 1 (feature_evaluator.cpp:720-728).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

PROB_THRESH_LOW = 0.5
MIN_OBS = 3
CHI2_POSE_THRESH = 12.59159  # 95% quantile, 6 dof
MIN_ANG_VEL = np.pi * 10.0 / 180.0  # rad/s
MIN_LIN_VEL = 0.3                    # m/s
MIN_HORIZON = 20
MAX_HORIZON = 35


def compute_keypt_qual_scores(
    chi2: np.ndarray,        # (N,) per-keypoint chi2 from pose optimization
    chi2_dof: np.ndarray,    # (N,) 2 (mono), 3 (stereo), 0 = unused
    found_count: np.ndarray,  # (N,) MapPoint::GetFound of the matched point
    prob_thresh_high: float = 0.99,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (qual_score_norm in [-1, 1], active mask). Points with a
    short track (< 3 found) and confident-good scores are pruned from the
    active set (chi2_dof cleared in the reference)."""
    from scipy.stats import chi2 as chi2_dist

    th_hi = {2: chi2_dist.ppf(prob_thresh_high, 2),
             3: chi2_dist.ppf(prob_thresh_high, 3)}
    th_lo = {2: chi2_dist.ppf(PROB_THRESH_LOW, 2),
             3: chi2_dist.ppf(PROB_THRESH_LOW, 3)}
    qual = np.zeros_like(chi2, np.float32)
    active = chi2_dof > 0
    for dof in (2, 3):
        sel = chi2_dof == dof
        scaled = np.clip(
            (chi2 - th_lo[dof]) / (th_hi[dof] - th_lo[dof]), 0.0, 1.0
        )
        q = 2.0 * (1.0 / (1.0 + scaled)) - 1.0
        qual = np.where(sel, q.astype(np.float32), qual)
    prune = active & (found_count < MIN_OBS) & (qual > 0.5)
    return qual, active & ~prune


def unsup_error_values(qual_norm: np.ndarray) -> np.ndarray:
    """err = 2 / (1 + qual) - 1 (feature_evaluator.cpp:720-728)."""
    return 2.0 / (1.0 + qual_norm) - 1.0


def relative_pose_error(
    T_est_ref: np.ndarray, T_est_cur: np.ndarray,
    T_gt_ref: np.ndarray, T_gt_cur: np.ndarray,
) -> np.ndarray:
    """6-vector (axis-angle rot, translation) of the discrepancy between
    estimated and GT relative motion (FeatureEvaluator::CalcRelativePoseError,
    fe.cpp:2064-2130). Inputs are camera-to-world poses."""
    rel_est = np.linalg.inv(T_est_ref) @ T_est_cur
    rel_gt = np.linalg.inv(T_gt_ref) @ T_gt_cur
    err = np.linalg.inv(rel_gt) @ rel_est
    R = err[:3, :3]
    cos_t = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    angle = np.arccos(cos_t)
    if abs(np.sin(angle)) < 1e-9:
        axis_angle = np.zeros(3)
    else:
        vee = np.array(
            [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
        )
        axis_angle = vee / (2.0 * np.sin(angle)) * angle
    return np.concatenate([axis_angle, err[:3, 3]])


def evaluate_tracking_accuracy(
    pose_err6: np.ndarray,
    rel_gt_from_last_kf: Optional[np.ndarray],
    dt: float,
    ang_var_inv: float = 2.0e3,
    trans_var_inv: float = 2.0e2,
) -> bool:
    """Reliability decision given the 6-dof pose error over the horizon and
    GT motion since the last keyframe (velocity gate)."""
    if rel_gt_from_last_kf is not None and dt > 0:
        t = rel_gt_from_last_kf[:3, 3]
        R = rel_gt_from_last_kf[:3, :3]
        cos_t = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
        ang = np.arccos(cos_t)
        if (np.linalg.norm(t) / dt < MIN_LIN_VEL
                and ang / dt < MIN_ANG_VEL):
            return False
    info = np.diag([ang_var_inv] * 3 + [trans_var_inv] * 3)
    chi2 = float(pose_err6 @ info @ pose_err6)
    return chi2 <= CHI2_POSE_THRESH
