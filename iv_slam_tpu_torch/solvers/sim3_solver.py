"""Sim(3) estimation: Horn closed form + batched RANSAC
(src/Sim3Solver.cc re-designed).

Port of ``iv_slam_tpu/solvers/sim3_solver.py``: every hypothesis is solved
in one batched closed-form pass and every (hypothesis, match) reprojection
check in another, the reference's acceptance test in both directions.

The reference draws its 3-point samples with ``jax.random`` under
``PRNGKey(kf_id)``, which torch cannot reproduce. So the RANSAC is split:
``sample_sim3`` draws the (n_hyp, 3) index array from a CPU
``torch.Generator`` seeded with the same id (the card and the CPU path
draw alike) and ``sim3_ransac`` scores the hypotheses of any index array a
caller gives it; ``LoopClosing.sampler`` names the sampler in use.

Horn's solve (centroids, correlation matrix, the 4x4 eigenproblem) runs in
float64 and its R, t, s are rounded once to float32, so the card and the
CPU agree; the reference solves in float32, so its R, t, s differ from
these by float32 rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import numerics


class Sim3Result(NamedTuple):
    R: torch.Tensor        # (3, 3)
    t: torch.Tensor        # (3,)
    s: torch.Tensor        # ()
    inliers: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor


def sample_sim3(key_id: int, n_hyp: int, n_valid: int, device) -> torch.Tensor:
    """(n_hyp, 3) int64 sample indices, uniform over [0, max(n_valid, 1)):
    the real-match prefix (Sim3Solver samples mvAllIndices, the actual
    matches), drawn on the CPU from a generator seeded with key_id."""
    g = torch.Generator().manual_seed(int(key_id))
    idx = torch.randint(0, max(int(n_valid), 1), (n_hyp, 3), generator=g)
    return idx.to(device)


def horn_sim3(P1: torch.Tensor, P2: torch.Tensor, fix_scale: bool = False):
    """Closed-form similarity P2 ~ s R P1 + t from paired (..., N, 3)
    points (Horn 1987, as Sim3Solver::ComputeSim3); batched over leading
    axes. Returns float32 (R, t, s)."""
    P1, P2 = P1.double(), P2.double()
    c1 = P1.mean(dim=-2)
    c2 = P2.mean(dim=-2)
    X1 = P1 - c1[..., None, :]
    X2 = P2 - c2[..., None, :]
    M = X1.transpose(-1, -2) @ X2   # S[i][j] = sum x1_i * x2_j
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    rows = [
        [Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
        [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
        [Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
        [Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz],
    ]
    N = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
    _vals, vecs = torch.linalg.eigh(N)
    q = vecs[..., :, -1]  # [w, x, y, z] of the largest eigenvalue
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)
    if fix_scale:
        s = torch.ones_like(w)
    else:
        # Horn's scale: the projection of X2 on the rotated X1 over |X1|^2
        num = (X2 * (X1 @ R.transpose(-1, -2))).sum(dim=(-1, -2))
        den = (X1 * X1).sum(dim=(-1, -2))
        s = num / torch.clamp(den, min=1e-12)
    t = c2 - s[..., None] * (R @ c1[..., None])[..., 0]
    return R.float(), t.float(), s.float()


def _project(p, fx, fy, cx, cy):
    z = torch.clamp(p[..., 2], min=1e-9)
    return torch.stack([fx * p[..., 0] / z + cx, fy * p[..., 1] / z + cy], dim=-1)


def sim3_ransac(
    P1: torch.Tensor,       # (N, 3) points in frame 1 camera coordinates
    P2: torch.Tensor,       # (N, 3) matched points in frame 2 camera coordinates
    uv1: torch.Tensor,      # (N, 2) observed pixels in frame 1
    uv2: torch.Tensor,      # (N, 2) observed pixels in frame 2
    sigma2: torch.Tensor,   # (N,) per-match scale variance
    valid: torch.Tensor,    # (N,) bool
    fx, fy, cx, cy,         # Python numbers
    idx: torch.Tensor,      # (n_hyp, 3) sample indices (sample_sim3)
    fix_scale: bool = False,
) -> Sim3Result:
    """Score one Horn hypothesis per row of `idx` with the reference's
    acceptance test, reprojection error < 9.210 * sigma2
    (Sim3Solver::CheckInliers) in both directions, and return the first
    hypothesis of the most inliers."""
    Rs, ts, ss = horn_sim3(P1[idx], P2[idx], fix_scale)     # (H, 3, 3), (H, 3), (H,)
    # both directions: P1 -> frame 2, P2 -> frame 1
    P1in2 = ss[:, None, None] * numerics.matmul(P1[None], Rs.transpose(1, 2)) + ts[:, None]
    Rinv = Rs.transpose(1, 2)
    P2c = (P2[None] - ts[:, None]) / ss[:, None, None]
    P2in1 = numerics.matmul(P2c, Rinv.transpose(1, 2))
    d2 = _project(P1in2, fx, fy, cx, cy) - uv2[None]
    d1 = _project(P2in1, fx, fy, cx, cy) - uv1[None]
    e2 = d2[..., 0] * d2[..., 0] + d2[..., 1] * d2[..., 1]
    e1 = d1[..., 0] * d1[..., 0] + d1[..., 1] * d1[..., 1]
    th = 9.210 * sigma2[None]
    inl = (e1 < th) & (e2 < th) & valid[None]
    counts = inl.sum(dim=1, dtype=torch.int32)
    best = torch.argmax(counts)                       # the first maximum
    return Sim3Result(R=Rs[best], t=ts[best], s=ss[best], inliers=inl[best],
                      n_inliers=counts[best])
