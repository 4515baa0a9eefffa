"""Trajectory writers in the reference's output formats
(System::SaveTrajectoryKITTI / SaveTrajectoryTUM, System.cc:614-772) and
trajectory error metrics.

Port of ``iv_slam_tpu/io/trajectory.py`` (numpy; the TUM writer's quaternion
comes from the port's ``geometry/se3.py`` on the CPU)."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..geometry import se3


def save_kitti(path: str, poses_twc: Sequence[np.ndarray]):
    """One 3x4 row-major Twc per line (KITTI odometry format)."""
    with open(path, "w") as f:
        for T in poses_twc:
            row = T[:3, :4].reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in row) + "\n")


def save_times(path: str, times: Sequence[float]):
    """Per-frame timestamps (KITTI_time_###.txt companion file)."""
    with open(path, "w") as f:
        for t in times:
            f.write(f"{t:.6e}\n")


def save_tum(path: str, times: Sequence[float], poses_twc: Sequence[np.ndarray]):
    """timestamp tx ty tz qx qy qz qw per line (TUM format)."""
    import torch

    with open(path, "w") as f:
        for t, T in zip(times, poses_twc):
            R = torch.tensor(np.asarray(T[:3, :3], np.float32))
            q = se3.rot_to_quat(R).numpy()
            tr = T[:3, 3]
            f.write(
                f"{t:.6e} {tr[0]:.9e} {tr[1]:.9e} {tr[2]:.9e} "
                f"{q[0]:.9e} {q[1]:.9e} {q[2]:.9e} {q[3]:.9e}\n"
            )


def load_kitti(path: str) -> List[np.ndarray]:
    out = []
    with open(path) as f:
        for line in f:
            vals = np.array([float(x) for x in line.split()], np.float32)
            T = np.eye(4, dtype=np.float32)
            T[:3, :4] = vals.reshape(3, 4)
            out.append(T)
    return out


def ate_rmse(
    est: Sequence[np.ndarray], gt: Sequence[np.ndarray],
    align_scale: bool = False,
) -> float:
    """Absolute trajectory error after SE3 (Umeyama, no scale) alignment —
    the evo_ape protocol the reference's evaluation scripts use
    (scripts/evaluation/evaluate_batch.py:43-55). align_scale=True adds
    the Umeyama scale term (evo's ``-as``, the monocular protocol)."""
    P = np.stack([T[:3, 3] for T in est])
    Q = np.stack([T[:3, 3] for T in gt])
    mu_p, mu_q = P.mean(0), Q.mean(0)
    Pc, Qc = P - mu_p, Q - mu_q
    U, D, Vt = np.linalg.svd(Pc.T @ Qc)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = (U @ S @ Vt).T
    s = 1.0
    if align_scale:
        var_p = np.mean(np.sum(Pc ** 2, axis=1))
        if var_p > 1e-12:
            s = float(np.trace(np.diag(D) @ S)) / (var_p * len(P))
    t = mu_q - s * (R @ mu_p)
    aligned = s * (P @ R.T) + t
    return float(np.sqrt(np.mean(np.sum((aligned - Q) ** 2, axis=1))))


def _metric_pairs(gt: Sequence[np.ndarray], delta_m: float):
    """Frame-index pairs (i, j) spaced ~delta_m meters apart along the GT
    path — evo's ``--delta ... --delta_unit m`` pairing (consecutive, not
    all-pairs), the reference's protocol with Δ = 2 m Jackal / 20 m AirSim /
    1 m EuRoC (scripts/evaluation/evaluate_batch.py:43-55)."""
    pts = np.stack([T[:3, 3] for T in gt])
    arc = np.concatenate(
        [[0.0], np.cumsum(np.linalg.norm(np.diff(pts, axis=0), axis=1))]
    )
    pairs = []
    i = 0
    for j in range(1, len(gt)):
        if arc[j] - arc[i] >= delta_m:
            pairs.append((i, j))
            i = j
    return pairs


def rpe(
    est: Sequence[np.ndarray],
    gt: Sequence[np.ndarray],
    delta: int = 1,
    kind: str = "trans",
    delta_m: float = None,
):
    """Relative pose error over frame pairs, RMSE.

    kind="trans" → meters; kind="rot" → degrees (the reference evaluates
    both splits, rot_/trans_ result prefixes in evaluate_batch.py:43-55 and
    evaluate_batch_viz.py:28). Pairs are `delta` frames apart, or ~delta_m
    meters apart along the GT path when delta_m is given."""
    if delta_m is not None:
        pairs = _metric_pairs(gt, delta_m)
    else:
        pairs = [(i, i + delta) for i in range(len(est) - delta)]
    errs = []
    for i, j in pairs:
        de = np.linalg.inv(est[i]) @ est[j]
        dg = np.linalg.inv(gt[i]) @ gt[j]
        err = np.linalg.inv(dg) @ de
        if kind == "rot":
            c = (np.trace(err[:3, :3]) - 1.0) / 2.0
            errs.append(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))
        else:
            errs.append(np.linalg.norm(err[:3, 3]))
    if not errs:
        return 0.0
    return float(np.sqrt(np.mean(np.square(errs))))
