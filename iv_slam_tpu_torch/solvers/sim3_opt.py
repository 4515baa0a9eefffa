"""Sim3 relative-pose refinement over matched map points
(Optimizer::OptimizeSim3, Optimizer.cc:2018-2216).

Port of ``iv_slam_tpu/solvers/sim3_opt.py``: given matched map points
between two keyframes, optimize the Sim3 S12 with mutual reprojection
edges (point j of KF2 projected into KF1 through S12, point i of KF1 into
KF2 through S12^-1), Huber delta sqrt(10); outliers (chi2 > 10) removed
once, then more iterations, the reference's two-stage schedule.

The LM keeps the reference's trial and accept logic: lambda seeded at
1e-5 * max diag(H), accept on rho > 0 with the 1/3..2/3 scaling, reject
with lambda *= ni, at most MAX_TRIALS trials an iteration; each trial's
accept flag is read on the host. The Jacobian of the 7-dof residual is
the forward-mode derivative (``geometry/sim3.py::jacobian7``) of the
same composition the reference differentiates with ``jax.jacfwd``.
H = J^T J, g and the solve run in float64, the cost sums in float64
rounded once to float32, so the card and the CPU agree.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import numerics
from ..geometry import sim3 as s3

TH2 = 10.0
MAX_TRIALS = 10


class Sim3OptResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


_DELTA = float(np.sqrt(np.float32(TH2), dtype=np.float32))   # jnp.sqrt(TH2) in float32


def _huber(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c <= TH2, c, 2.0 * _DELTA * numerics.sqrt(torch.clamp(c, min=1e-12)) - TH2)


def optimize_sim3(
    R0, t0, s0,               # initial S12 (tensors)
    P1: torch.Tensor,         # (N, 3) map points in the KF1 camera frame
    P2: torch.Tensor,         # (N, 3) matched map points in the KF2 camera frame
    uv1: torch.Tensor,        # (N, 2) observations in KF1
    uv2: torch.Tensor,        # (N, 2) observations in KF2
    inv_sigma2_1: torch.Tensor,
    inv_sigma2_2: torch.Tensor,
    valid: torch.Tensor,
    fx, fy, cx, cy,           # Python numbers
    fix_scale: bool = False,
    n_iters: int = 10,
) -> Sim3OptResult:
    dev = P1.device
    zero7 = torch.zeros(7, device=dev)

    def project(p):
        z = torch.clamp(p[..., 2], min=1e-9)
        return torch.stack([fx * p[..., 0] / z + cx, fy * p[..., 1] / z + cy], dim=-1)

    def residuals(xi, R, t, s):
        S = s3.sim3_exp(xi).compose(s3.Sim3(R, t, s))
        e1 = uv1 - project(S.act(P2))            # KF2 points into KF1
        e2 = uv2 - project(S.inverse().act(P1))  # KF1 points into KF2
        return e1, e2

    def chi2s(R, t, s):
        e1, e2 = residuals(zero7, R, t, s)
        c1 = inv_sigma2_1 * (e1[:, 0] * e1[:, 0] + e1[:, 1] * e1[:, 1])
        c2 = inv_sigma2_2 * (e2[:, 0] * e2[:, 0] + e2[:, 1] * e2[:, 1])
        return c1, c2

    def total_cost(R, t, s, mask):
        c1, c2 = chi2s(R, t, s)
        return numerics.total(torch.where(mask, _huber(c1) + _huber(c2), 0.0), dim=0)

    def build(R, t, s, mask):
        w1 = numerics.sqrt(inv_sigma2_1 * mask)
        w2 = numerics.sqrt(inv_sigma2_2 * mask)

        def res_flat(xi):     # (1, 7) -> (1, 4N)
            e1, e2 = residuals(xi, R, t, s)
            return torch.cat([(e1 * w1[:, None]).reshape(1, -1),
                              (e2 * w2[:, None]).reshape(1, -1)], dim=1)

        e = res_flat(zero7[None])[0].double()
        J = s3.jacobian7(res_flat, zero7[None])[0].double()    # (4N, 7)
        if fix_scale:
            J = torch.cat([J[:, :6], torch.zeros_like(J[:, 6:])], dim=1)
        return J.T @ J, -(J.T @ e)                               # float64

    fix7 = torch.arange(7, device=dev) == 6

    def lm(R, t, s, mask, iters):
        mask = mask.to(torch.float32)
        chi = total_cost(R, t, s, mask > 0)
        lam = ni = None
        for it in range(iters):
            H, g = build(R, t, s, mask)
            if it == 0:
                lam = (1e-5 * torch.diagonal(H).abs().max() + 1e-9).float()
                ni = torch.full_like(lam, 2.0)
            rho, trials, done = -1.0, 0, False
            while not done and rho < 0 and trials < MAX_TRIALS:
                diag = torch.where(fix7 & fix_scale, 1.0, lam).double()
                dx = torch.linalg.solve_ex(H + torch.diag(diag + 1e-12), g)[0]
                if fix_scale:
                    dx = torch.where(fix7, 0.0, dx)
                scale = (dx @ (lam.double() * dx + g)).float() + 1e-3
                dx = dx.float()
                S_new = s3.sim3_exp(dx).compose(s3.Sim3(R, t, s))
                chi_new = total_cost(S_new.R, S_new.t, S_new.s, mask > 0)
                rho_t = (chi - chi_new) / scale
                good_t = (rho_t > 0) & torch.isfinite(chi_new)
                a = 2.0 * rho_t - 1.0
                lam_good = lam * torch.clamp(1.0 - a * a * a, 1.0 / 3.0, 2.0 / 3.0)
                flag, rho = torch.stack([good_t.to(rho_t.dtype), rho_t]).tolist()
                done = flag != 0.0
                if done:
                    R, t, s, lam, chi = S_new.R, S_new.t, S_new.s, lam_good, chi_new
                    ni = torch.full_like(ni, 2.0)
                else:
                    lam, ni = lam * ni, ni * 2.0
                trials += 1
        return R, t, s

    s0 = torch.as_tensor(s0, dtype=torch.float32, device=dev)
    R1, t1, s1 = lm(R0, t0, s0, valid, 5)
    c1, c2 = chi2s(R1, t1, s1)
    inlier = valid & (c1 <= TH2) & (c2 <= TH2)
    R2, t2, s2 = lm(R1, t1, s1, inlier, n_iters)
    c1, c2 = chi2s(R2, t2, s2)
    final = valid & (c1 <= TH2) & (c2 <= TH2)
    return Sim3OptResult(R=R2, t=t2, s=s2, inliers=final,
                         n_inliers=final.sum(dtype=torch.int32))
