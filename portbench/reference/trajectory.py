"""Absolute trajectory error: the RMSE of camera centres after the rigid
(rotation + translation, no scale) alignment of Umeyama (1991) that best
maps the estimate onto the truth."""

from __future__ import annotations

import numpy as np


def ate_rmse(est_twc: np.ndarray, gt_twc: np.ndarray) -> float:
    """est_twc, gt_twc: (N, 4, 4) camera-to-world poses of the same frames."""
    if len(est_twc) != len(gt_twc):
        raise ValueError(f"{len(est_twc)} estimated poses for {len(gt_twc)} true ones")
    a = np.asarray(est_twc, np.float64)[:, :3, 3]
    b = np.asarray(gt_twc, np.float64)[:, :3, 3]
    ma, mb = a.mean(0), b.mean(0)
    cov = (b - mb).T @ (a - ma) / len(a)
    u, _, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1.0
    r = u @ s @ vt
    err = (a - ma) @ r.T + mb - b
    return float(np.sqrt(np.mean(np.sum(err * err, axis=1))))
