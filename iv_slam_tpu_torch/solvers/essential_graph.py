"""Sim(3) pose-graph optimization for loop closure
(Optimizer::OptimizeEssentialGraph, Optimizer.cc:1753-2016).

Port of ``iv_slam_tpu/solvers/essential_graph.py``. Vertices are
per-keyframe Sim3 world->camera transforms; edges (loop connections,
spanning tree, covisibility >= 100) constrain relative Sim3s. Every edge
residual e = log(S_meas * S_i * S_j^-1) and its two 7x7 Jacobians come
from forward-mode derivatives batched over the edges
(``geometry/sim3.py::jacobian7``; the reference's vmapped ``jax.jacfwd``);
the (7K, 7K) system is assembled from the edge blocks and solved dense,
with the reference's LM trial and accept logic (each trial's accept flag
read on the host).

The reference works in float32 throughout, and so does the state here;
the assembly (one product of the (7E, 7K) stacked Jacobian), the
solve and the cost sum run in float64 and are rounded once to float32,
so the card and the CPU agree.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import numerics
from ..geometry import sim3 as s3

MAX_TRIALS = 8


class EGProblem(NamedTuple):
    R: torch.Tensor        # (K, 3, 3) initial S_cw rotations
    t: torch.Tensor        # (K, 3)
    s: torch.Tensor        # (K,)
    fixed: torch.Tensor    # (K,) bool
    e_i: torch.Tensor      # (E,) int32
    e_j: torch.Tensor      # (E,)
    e_R: torch.Tensor      # (E, 3, 3) measured S_ji rotation
    e_t: torch.Tensor      # (E, 3)
    e_s: torch.Tensor      # (E,)
    e_valid: torch.Tensor  # (E,) bool


def _edge_residual(xi_i, xi_j, Si, Sj, Sm):
    """e = log(S_meas * exp(xi_i) S_i * (exp(xi_j) S_j)^-1), 7-vector."""
    Pi = s3.sim3_exp(xi_i).compose(Si)
    Pj = s3.sim3_exp(xi_j).compose(Sj)
    return s3.sim3_log(Sm.compose(Pi).compose(Pj.inverse()))


def optimize_essential_graph(prob: EGProblem, n_iters: int = 20, fix_scale: bool = False):
    """fix_scale=True pins every vertex's log-scale coordinate (g2o
    VertexSim3Expmap::_fix_scale, used for stereo/RGBD loop closure).
    Returns the optimized (R, t, s)."""
    K = prob.R.shape[0]
    dev = prob.R.device
    e_i, e_j = prob.e_i.long(), prob.e_j.long()
    zero = torch.zeros(e_i.shape[0], 7, device=dev)
    Sm = (prob.e_R, prob.e_t, prob.e_s)

    def residuals_and_jacs(R, t, s):
        Si = s3.Sim3(R[e_i], t[e_i], s[e_i])
        Sj = s3.Sim3(R[e_j], t[e_j], s[e_j])
        Sm_ = s3.Sim3(*Sm)
        e = _edge_residual(zero, zero, Si, Sj, Sm_)
        Ji = s3.jacobian7(lambda xi: _edge_residual(xi, zero, Si, Sj, Sm_), zero)
        Jj = s3.jacobian7(lambda xi: _edge_residual(zero, xi, Si, Sj, Sm_), zero)
        return e, Ji, Jj

    def residuals(R, t, s):
        return _edge_residual(zero, zero, s3.Sim3(R[e_i], t[e_i], s[e_i]),
                              s3.Sim3(R[e_j], t[e_j], s[e_j]), s3.Sim3(*Sm))

    def cost(R, t, s):
        e = residuals(R, t, s)
        return numerics.total(torch.where(prob.e_valid[:, None], e * e, 0.0).reshape(-1), dim=0)

    onehot_i = (e_i[:, None] == torch.arange(K, device=dev)[None, :]).double()   # (E, K)
    onehot_j = (e_j[:, None] == torch.arange(K, device=dev)[None, :]).double()
    fixed7 = prob.fixed.repeat_interleave(7)
    if fix_scale:
        fixed7 = fixed7 | (torch.arange(7 * K, device=dev) % 7 == 6)
    w = prob.e_valid.double()

    def apply_update(R, t, s, dx):
        dx = torch.where(prob.fixed[:, None], 0.0, dx.reshape(K, 7))
        new = s3.sim3_exp(dx).compose(s3.Sim3(R, t, s))
        return new.R, new.t, new.s

    R, t, s = prob.R, prob.t, prob.s
    chi = cost(R, t, s)
    lam = ni = None
    for it in range(n_iters):
        e, Ji, Jj = residuals_and_jacs(R, t, s)
        # the (7E, 7K) Jacobian of the stacked residuals: edge e's rows hold
        # Ji at vertex i and Jj at vertex j; H = A^T W A, g = -A^T W e
        A = (torch.einsum("ek,erc->erkc", onehot_i, Ji.double())
             + torch.einsum("ek,erc->erkc", onehot_j, Jj.double())).reshape(-1, 7 * K)
        wA = A * w.repeat_interleave(7)[:, None]
        Hf = wA.T @ A
        gf = -(wA.T @ e.double().reshape(-1))
        # the reference's float32 H and g, then fixed rows and columns zeroed
        Hf = torch.where(fixed7[:, None] | fixed7[None, :], 0.0, Hf.float())
        gf = torch.where(fixed7, 0.0, gf.float())
        if it == 0:
            lam = 1e-5 * torch.diagonal(Hf).abs().max() + 1e-8
            ni = torch.full_like(lam, 2.0)
        rho, trials, done = -1.0, 0, False
        while not done and rho < 0 and trials < MAX_TRIALS:
            Hd = Hf + torch.diag(torch.where(fixed7, 1.0, lam))
            dx = numerics.rounded(lambda a, b: torch.linalg.solve_ex(a, b)[0], Hd, gf)
            R2, t2, s2 = apply_update(R, t, s, dx)
            chi_new = cost(R2, t2, s2)
            scale = numerics.total(dx * (lam * dx + gf), dim=0) + 1e-3
            rho_t = (chi - chi_new) / scale
            good_t = (rho_t > 0) & torch.isfinite(chi_new)
            a = 2.0 * rho_t - 1.0
            lam_good = lam * torch.clamp(1.0 - a * a * a, 1.0 / 3.0, 2.0 / 3.0)
            flag, rho = torch.stack([good_t.to(rho_t.dtype), rho_t]).tolist()
            done = flag != 0.0
            if done:
                R, t, s, lam, chi = R2, t2, s2, lam_good, chi_new
                ni = torch.full_like(ni, 2.0)
            else:
                lam, ni = lam * ni, ni * 2.0
            trials += 1
    return R, t, s
