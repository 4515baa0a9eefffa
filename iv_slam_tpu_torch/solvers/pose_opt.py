"""Motion-only pose optimization: batched Levenberg-Marquardt over SE(3).

Port of ``iv_slam_tpu/solvers/pose_opt.py`` (Optimizer::PoseOptimization,
Optimizer.cc:251-503, through g2o). Semantics reproduced:

  * unary edges: residual = obs - proj(T X), information = I * invLevelSigma2
  * Huber robust kernel with quality-scaled delta:
      delta = sqrt(5.991) * qual (mono) / sqrt(7.815) * qual (stereo)
  * g2o Levenberg damping: additive lambda, init = 1e-5 * max(diag H),
    accept if rho > 0 with lambda *= max(1/3, min(2/3, 1-(2rho-1)^3)),
    reject with lambda *= ni, ni *= 2, up to MAX_TRIALS trials per iteration
  * 4 rounds x 10 iterations; every round restarts from the initial pose
    with the surviving inlier set; outliers reclassified by unrobust chi2
    vs {5.991, 7.815}; the robust kernel is dropped after round
    min(2, n_rounds-2)

The trials of one iteration run as one batch, so the solver never waits on
the host. A rejected trial leaves T and chi2 as they were and only scales
lambda by ni and ni by 2, so the damping of every trial an iteration may
need is known before the first is tried. The batch solves all MAX_TRIALS
damped systems and costs them at once, then takes the first trial at which
the reference's loop ends: it accepts a trial with rho > 0 and a finite
cost, and stops at rho >= 0 or NaN. That gives the sequential loop's T,
lambda, ni and chi2, the no-exit case after MAX_TRIALS rejections
included.

On the card one launch of a hand-written kernel runs it all
(``csrc/pose_lm.cu``, wrapper ``pose_opt_cuda.py``): ``pose_optimization``
sends CUDA tensors there and CPU tensors to the plain twin,
``pose_optimization_plain``, the eager form below, which the kernel equals
bit for bit on the card. Each call records the span ``pose_lm.kernel`` or
``pose_lm.plain``.

Every sum, solve, root and matrix product goes through ``numerics``, so a
trial whose gain lies at the float32 rounding of the cost sum is accepted
or rejected alike on the CPU and on the GPU. The cost sums and the 6x6
solves are float64, rounded once. H and g keep the reference's float32
rounding, summed as a fixed pairwise tree: the pose that 10 iterations
reach along a weakly constrained direction depends on it (an H summed in
float64 ends a round on tests/test_torch_fused_track.py's slice ~2e-4 from
the reference's pose; float32 sums in any order end within ~1e-5).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import numerics
from ..geometry import camera, se3
from ..utils.profiling import span
from . import pose_opt_cuda

DELTA_MONO_SQ = 5.991
DELTA_STEREO_SQ = 7.815
MAX_TRIALS = 10


class PoseOptResult(NamedTuple):
    T: torch.Tensor          # (4, 4) optimized Tcw
    inlier: torch.Tensor     # (N,) bool (valid edges classified inlier)
    chi2: torch.Tensor       # (N,) float32 final unrobust chi2 (logging mode)
    n_inliers: torch.Tensor  # () int32


def _residuals(T, Xw, obs, is_stereo, K):
    """e = obs - proj(T X); mono edges zero their third component. T may
    carry leading batch axes; e and pc then carry them too."""
    pc = se3.transform_points(T, Xw)
    e = obs - camera.project_stereo(K, pc)
    e = torch.cat([e[..., :2], torch.where(is_stereo, e[..., 2], 0.0)[..., None]],
                  dim=-1)
    return e, pc


def _jacobian(pc, is_stereo, K):
    """de/dxi for left-multiplied update exp(xi) T, xi = (omega, upsilon):
    J = Jproj @ [hat(p) | -I]."""
    Jp = camera.proj_jacobian_stereo(K, pc)  # (N, 3, 3)
    J = torch.cat([numerics.matmul(Jp, se3.hat(pc)), -Jp], dim=-1)  # (N, 3, 6)
    return torch.cat([J[:, :2], torch.where(is_stereo[:, None], J[:, 2], 0.0)[:, None]],
                     dim=1)


def _chi2(e, inv_sigma2):
    return inv_sigma2 * se3.sum3(e, e)


def _huber_rho0(chi2, delta_sq, active: bool):
    """Robust cost rho0 (g2o RobustKernelHuber) when the kernel is active."""
    if not active:
        return chi2
    delta = numerics.sqrt(delta_sq)
    lin = 2.0 * delta * numerics.sqrt(torch.clamp(chi2, min=1e-12)) - delta_sq
    return torch.where(chi2 <= delta_sq, chi2, lin)


def _huber_w(chi2, delta_sq, active: bool):
    """IRLS weight rho1 = delta/|e| outside the inlier band."""
    if not active:
        return torch.ones_like(chi2)
    return torch.where(chi2 <= delta_sq, 1.0,
                       numerics.sqrt(delta_sq / torch.clamp(chi2, min=1e-12)))


def _total_cost(T, Xw, obs, inv_sigma2, delta_sq, is_stereo, mask, K, kernel_on):
    e, _ = _residuals(T, Xw, obs, is_stereo, K)
    rob = _huber_rho0(_chi2(e, inv_sigma2), delta_sq, kernel_on)
    return numerics.total(torch.where(mask, rob, 0.0), dim=-1)


def _normal_equations(T, Xw, obs, inv_sigma2, delta_sq, is_stereo, mask, K, kernel_on):
    """H = J^T W J and g = -J^T W e at T, IRLS-weighted: the (3N, 42)
    products of every residual row, summed over the rows as a float32
    tree."""
    e, pc = _residuals(T, Xw, obs, is_stereo, K)
    w = _huber_w(_chi2(e, inv_sigma2), delta_sq, kernel_on) * inv_sigma2
    w = torch.where(mask, w, 0.0)
    J = _jacobian(pc, is_stereo, K)                                # (N, 3, 6)
    Jw = (J * w[:, None, None]).reshape(-1, 6)
    Jr = J.reshape(-1, 6)
    s = numerics.tree_sum(torch.cat([(Jw[:, :, None] * Jr[:, None, :]).reshape(-1, 36),
                                     Jw * e.reshape(-1, 1)], dim=1))
    return s[:36].reshape(6, 6), -s[36:]


def _damped_step(H, lam, g):
    """dx with (H + lam I) dx = g, for a (k,) batch of lam: (k, 6)."""
    Hd = H + torch.diag_embed(lam[:, None].expand(lam.shape[0], 6))
    return numerics.rounded(
        lambda A, b: torch.linalg.solve_ex(A, b, check_errors=False)[0],
        Hd, g.expand(lam.shape[0], 6))


def _gain_scale(dx, lam, g):
    """The predicted gain dx . (lam dx + g) + 1e-3, rho's denominator."""
    return numerics.total(dx * (lam[:, None] * dx + g), dim=-1) + 1e-3


def _damping_ladder(lam0, ni0):
    """lambda and ni before trial k = 0..MAX_TRIALS of one iteration, when
    every trial before k was rejected (lambda_{k+1} = lambda_k * ni_k,
    ni_{k+1} = 2 ni_k). ni is always a power of two, so every product is
    lambda_0 times a power of two: exact in float64 in any order, and
    rounded once to the float32 the sequential loop computes (inf where
    that loop overflows)."""
    dev = lam0.device
    two = torch.cat([torch.ones(1, dtype=torch.float64, device=dev),
                     torch.full((MAX_TRIALS,), 2.0, dtype=torch.float64, device=dev)])
    ni = ni0.to(torch.float64) * torch.cumprod(two, 0)
    lam = torch.cumprod(torch.cat([lam0.to(torch.float64)[None], ni[:-1]]), 0)
    return lam.to(torch.float32), ni.to(torch.float32)


def _lm_round(
    T0, Xw, obs, inv_sigma2, delta_sq, is_stereo, mask, K, kernel_on: bool,
    n_iters: int,
):
    """One g2o-style LM round from T0 over the masked edge set.

    Returns (T, trials): the final pose and the number of trials each
    iteration took, an (n_iters,) int32 tensor."""
    dev = T0.device
    trial_idx = torch.arange(MAX_TRIALS, device=dev)

    def cost(T):
        return _total_cost(T, Xw, obs, inv_sigma2, delta_sq, is_stereo, mask, K,
                           kernel_on)

    T, chi = T0, cost(T0)
    lam = ni = None
    trials = []
    for it in range(n_iters):
        H, g = _normal_equations(T, Xw, obs, inv_sigma2, delta_sq, is_stereo, mask,
                                 K, kernel_on)
        if it == 0:
            lam = 1e-5 * torch.diagonal(H).abs().amax()
            ni = torch.full((), 2.0, dtype=torch.float32, device=dev)
        lam_k, ni_k = _damping_ladder(lam, ni)

        # every trial of this iteration at once
        lam_t = lam_k[:MAX_TRIALS]
        dx = _damped_step(H, lam_t, g)
        T_new = numerics.matmul(se3.se3_exp(dx), T)
        chi_new = cost(T_new)
        rho = (chi - chi_new) / _gain_scale(dx, lam_t, g)
        good = (rho > 0) & torch.isfinite(chi_new)
        a = 2.0 * rho - 1.0
        lam_good = lam_t * torch.clamp(1.0 - a * a * a, 1.0 / 3.0, 2.0 / 3.0)

        # the trial at which the sequential loop ends (the last one when
        # all MAX_TRIALS were rejected), picked on the device
        stop = good | ~(rho < 0)
        s = torch.where(stop, trial_idx, MAX_TRIALS - 1).amin().reshape(1)
        ok = good.index_select(0, s)[0]
        T = torch.where(ok, T_new.index_select(0, s)[0], T)
        lam = torch.where(ok, lam_good.index_select(0, s), lam_k.index_select(0, s + 1))[0]
        ni = torch.where(ok, 2.0, ni_k.index_select(0, s + 1))[0]
        chi = torch.where(ok, chi_new.index_select(0, s), chi)[0]
        trials.append(s + 1)
    return T, torch.cat(trials).to(torch.int32)


def pose_optimization(
    T0: torch.Tensor,          # (4, 4) initial Tcw
    Xw: torch.Tensor,          # (N, 3) world points
    obs: torch.Tensor,         # (N, 3) [u, v, u_r]; u_r < 0 => mono edge
    inv_sigma2: torch.Tensor,  # (N,) per-octave information
    qual: torch.Tensor,        # (N,) introspection quality scores (1 = clean)
    valid: torch.Tensor,       # (N,) bool edge exists
    K: camera.Intrinsics,
    n_rounds: int = 4,
    n_iters: int = 10,
) -> PoseOptResult:
    """The pose LM: one kernel launch for CUDA tensors (the intrinsics on the
    same device), the plain twin for CPU tensors."""
    if T0.device.type == "cuda":
        with span("pose_lm.kernel"):
            return PoseOptResult(*pose_opt_cuda.pose_lm(
                T0, Xw, obs, inv_sigma2, qual, valid, K, n_rounds, n_iters))
    with span("pose_lm.plain"):
        return pose_optimization_plain(T0, Xw, obs, inv_sigma2, qual, valid, K,
                                       n_rounds, n_iters)


def pose_optimization_plain(
    T0: torch.Tensor,          # (4, 4) initial Tcw
    Xw: torch.Tensor,          # (N, 3) world points
    obs: torch.Tensor,         # (N, 3) [u, v, u_r]; u_r < 0 => mono edge
    inv_sigma2: torch.Tensor,  # (N,) per-octave information
    qual: torch.Tensor,        # (N,) introspection quality scores (1 = clean)
    valid: torch.Tensor,       # (N,) bool edge exists
    K: camera.Intrinsics,
    n_rounds: int = 4,
    n_iters: int = 10,
) -> PoseOptResult:
    is_stereo = obs[:, 2] >= 0
    delta_base_sq = torch.where(is_stereo, DELTA_STEREO_SQ, DELTA_MONO_SQ)
    # quality scales the Huber *delta* (not delta^2): delta' = delta * qual
    delta_sq = delta_base_sq * qual * qual
    chi2_th = delta_base_sq

    inlier = valid
    T_cur = T0
    c2 = torch.zeros(Xw.shape[0], dtype=torch.float32, device=T0.device)
    for r in range(n_rounds):
        # the kernel is removed during the classification pass of round
        # min(2, n_rounds-2), so later rounds optimize without it
        kernel_on = r <= min(2, n_rounds - 2)
        T_cur, _ = _lm_round(T0, Xw, obs, inv_sigma2, delta_sq, is_stereo,
                             valid & inlier, K, kernel_on, n_iters)
        e, _ = _residuals(T_cur, Xw, obs, is_stereo, K)
        c2 = _chi2(e, inv_sigma2)
        inlier = valid & (c2 <= chi2_th)

    return PoseOptResult(T=T_cur, inlier=inlier, chi2=c2,
                         n_inliers=inlier.sum(dtype=torch.int32))
