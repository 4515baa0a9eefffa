"""Robust PnP for relocalization (src/PnPsolver.cc role).

Port of ``iv_slam_tpu/solvers/pnp.py``: 4-point minimal-sample RANSAC gated
at chi2 5.991 * sigma2, each hypothesis solved by EPnP (PnPsolver.cc:376-470
compute_pose: control points -> barycentric M -> 12x12 null space -> beta
cases N=1..3 + Gauss-Newton -> Horn alignment), all hypotheses and beta
cases batched. ``_dlt_pose`` is the batched 6-point DLT alternative.

The reference draws its samples with ``jax.random.choice`` under
``PRNGKey(frame_id)``, which torch cannot reproduce: ``sample_pnp`` draws
the (n_hyp, 4) index array from a CPU ``torch.Generator`` seeded with the
same id, and ``pnp_ransac`` scores the hypotheses of the index array it
is given (``Tracking.pnp_sampler`` names the sampler in use).

The hypothesis solvers run in float64 (eigen/SVD/solves, the Gauss-Newton
betas with their 6x4 Jacobian written out) and round each pose once to
float32, so the card and the CPU agree; the scoring is float32 in the
reference's order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import numerics


class PnPResult(NamedTuple):
    T: torch.Tensor         # (4, 4) Tcw
    inliers: torch.Tensor   # (N,) bool
    n_inliers: torch.Tensor
    ok: torch.Tensor        # () bool: enough inliers found


def sample_pnp(key_id: int, valid: np.ndarray, n_hyp: int = 300, sample_size: int = 4,
               device=None) -> torch.Tensor:
    """(n_hyp, sample_size) int64 indices, each row distinct indices drawn
    uniformly from the valid ones (invalid ones only where fewer are
    valid), from a CPU generator seeded with key_id."""
    g = torch.Generator().manual_seed(int(key_id))
    u = torch.rand((n_hyp, len(valid)), generator=g, dtype=torch.float64)
    u = torch.where(torch.as_tensor(np.asarray(valid, bool))[None], u, 2.0)
    idx = torch.argsort(u, dim=1, stable=True)[:, :sample_size]
    return idx.to(device)


def _rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    bottom = torch.cat([R.new_zeros(R.shape[:-2] + (1, 3)), R.new_ones(R.shape[:-2] + (1, 1))],
                       dim=-1)
    return torch.cat([torch.cat([R, t[..., None]], dim=-1), bottom], dim=-2)


def _dlt_pose(X: torch.Tensor, uv_n: torch.Tensor) -> torch.Tensor:
    """DLT: world points (..., S, 3) + normalized image points (..., S, 2)
    -> (..., 4, 4) [R|t] with orthonormalized R (SVD cleanup)."""
    X, uv_n = X.double(), uv_n.double()
    zeros = torch.zeros(X.shape[:-1] + (4,), dtype=X.dtype, device=X.device)
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    rows_u = torch.cat([Xh, zeros, -uv_n[..., :1] * Xh], dim=-1)
    rows_v = torch.cat([zeros, Xh, -uv_n[..., 1:2] * Xh], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=-2)                     # (..., 2S, 12)
    _, _, Vt = torch.linalg.svd(A, full_matrices=True)
    P = Vt[..., -1, :].reshape(X.shape[:-2] + (3, 4))
    # fix the sign: points should have positive depth
    depths = (Xh @ P[..., 2, :, None])[..., 0]
    P = P * torch.where(depths.sum(-1) < 0, -1.0, 1.0)[..., None, None]
    U, S, Vt2 = torch.linalg.svd(P[..., :3])
    scale = S.mean(-1)
    det = torch.linalg.det(U @ Vt2)
    U = torch.cat([U[..., :2], U[..., 2:] * torch.sign(det)[..., None, None]], dim=-1)
    R = U @ Vt2
    t = P[..., 3] / torch.clamp(scale, min=1e-12)[..., None]
    return _rt(R, t).float()


# ---------------------------------------------------------------- EPnP
# (Lepetit et al. 2009, as vendored in PnPsolver.cc)

# control-point pair indexing for the 6 inter-point distance constraints
_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _beta_products(b: torch.Tensor) -> torch.Tensor:
    """betas (..., 4) -> the 10 quadratic monomials in L_6x10's column
    order [b00,b01,b11,b02,b12,b22,b03,b13,b23,b33] (PnPsolver.cc:770-797)."""
    b0, b1, b2, b3 = b.unbind(-1)
    return torch.stack([b0 * b0, b0 * b1, b1 * b1, b0 * b2, b1 * b2,
                        b2 * b2, b0 * b3, b1 * b3, b2 * b3, b3 * b3], dim=-1)


def _beta_products_jac(b: torch.Tensor) -> torch.Tensor:
    """d _beta_products / d b, (..., 10, 4)."""
    b0, b1, b2, b3 = b.unbind(-1)
    z = torch.zeros_like(b0)
    cols = [
        [2 * b0, b1, z, b2, z, z, b3, z, z, z],
        [z, b0, 2 * b1, z, b2, z, z, b3, z, z],
        [z, z, z, b0, b1, 2 * b2, z, z, b3, z],
        [z, z, z, z, z, z, b0, b1, b2, 2 * b3],
    ]
    return torch.stack([torch.stack(c, dim=-1) for c in cols], dim=-1)


def _gauss_newton_betas(L, rho, betas, iters: int = 5):
    """Refine betas on the 6 control-point distance equations
    (PnPsolver.cc:832-858, 5 iterations); batched."""
    eye4 = torch.eye(4, dtype=L.dtype, device=L.device)
    for _ in range(iters):
        r = (L @ _beta_products(betas)[..., None])[..., 0] - rho           # (..., 6)
        J = L @ _beta_products_jac(betas)                                  # (..., 6, 4)
        JtJ = J.transpose(-1, -2) @ J + 1e-9 * eye4
        betas = betas - _solve(JtJ, J.transpose(-1, -2) @ r[..., None])[..., 0]
    return betas


def _solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched A^-1 B that never raises: a singular system gives
    non-finite rows (which the scorer rejects), as jnp.linalg.solve does."""
    return torch.linalg.solve_ex(A, B)[0]


def _finite(x: torch.Tensor, n_dims: int):
    """(x with non-finite entries zeroed, whether the trailing n_dims
    block was all finite): the eigen and SVD routines refuse NaN inputs."""
    ok = torch.isfinite(x).flatten(-n_dims).all(-1)
    return torch.where(torch.isfinite(x), x, 0.0), ok


def _horn_rt(pw: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    """Closed-form R, t of camera points from world points
    (estimate_R_and_t, PnPsolver.cc:875-931); batched, float64."""
    cw = pw.mean(dim=-2)
    cc = pc.mean(dim=-2)
    A = (pc - cc[..., None, :]).transpose(-1, -2) @ (pw - cw[..., None, :])
    U, _, Vt = torch.linalg.svd(A)
    sgn = torch.sign(torch.linalg.det(U @ Vt))
    U = torch.cat([U[..., :2], U[..., 2:] * sgn[..., None, None]], dim=-1)
    R = U @ Vt
    t = cc - (R @ cw[..., None])[..., 0]
    return _rt(R, t)


def _epnp_pose(X: torch.Tensor, uv_n: torch.Tensor) -> torch.Tensor:
    """EPnP on minimal samples: world points (..., S, 3) + normalized image
    points (..., S, 2) -> (..., 4, 4) float32 Tcw. Degenerate samples give
    NaN poses, which the RANSAC scorer rejects naturally."""
    X, uv_n = X.double(), uv_n.double()
    s = X.shape[-2]
    dt, dev = X.dtype, X.device
    eye = lambda n: torch.eye(n, dtype=dt, device=dev)  # noqa: E731
    # control points: centroid + principal directions (choose_control_points,
    # PnPsolver.cc:232-262)
    c0 = X.mean(dim=-2)
    Xc = X - c0[..., None, :]
    w, V = torch.linalg.eigh(Xc.transpose(-1, -2) @ Xc)         # ascending
    k = torch.sqrt(torch.clamp(w.flip(-1), min=0.0) / s)
    dirs = V.transpose(-1, -2).flip(-2)                          # rows, descending
    cws = torch.cat([c0[..., None, :], c0[..., None, :] + k[..., None] * dirs], dim=-2)
    # barycentric coordinates (compute_barycentric_coordinates, 264-288)
    CC = (cws[..., 1:, :] - cws[..., :1, :]).transpose(-1, -2)
    a123 = _solve(CC + 1e-12 * eye(3), (X - cws[..., :1, :]).transpose(-1, -2)).transpose(-1, -2)
    alphas, ok = _finite(torch.cat([1.0 - a123.sum(-1, keepdim=True), a123], dim=-1), 2)
    # M rows (fill_M, 290-306) in normalized coordinates
    zeros = torch.zeros_like(alphas)
    lead = X.shape[:-2]
    ru = torch.stack([alphas, zeros, -uv_n[..., 0:1] * alphas], -1).reshape(lead + (s, 12))
    rv = torch.stack([zeros, alphas, -uv_n[..., 1:2] * alphas], -1).reshape(lead + (s, 12))
    M = torch.cat([ru, rv], dim=-2)                                           # (..., 2S, 12)
    _, Vm = torch.linalg.eigh(M.transpose(-1, -2) @ M)                        # ascending
    vs = Vm.transpose(-1, -2)[..., :4, :].reshape(lead + (4, 4, 3))  # null vectors, smallest first
    # L_6x10 + rho (compute_L_6x10 / compute_rho, 744-806)
    ia = [a for a, _ in _PAIRS]
    ib = [b for _, b in _PAIRS]
    dv = vs[..., ia, :] - vs[..., ib, :]                                      # (..., 4, 6, 3)
    dot = torch.einsum("...aij,...bij->...abi", dv, dv)                       # (..., 4, 4, 6)
    L = torch.stack([
        dot[..., 0, 0, :], 2 * dot[..., 0, 1, :], dot[..., 1, 1, :], 2 * dot[..., 0, 2, :],
        2 * dot[..., 1, 2, :], dot[..., 2, 2, :], 2 * dot[..., 0, 3, :], 2 * dot[..., 1, 3, :],
        2 * dot[..., 2, 3, :], dot[..., 3, 3, :],
    ], dim=-1)                                                                # (..., 6, 10)
    dcw = cws[..., ia, :] - cws[..., ib, :]
    rho = (dcw * dcw).sum(-1)                                                 # (..., 6)

    def lsq(cols):
        Ls = L[..., list(cols)]
        Lt = Ls.transpose(-1, -2)
        return _solve(Lt @ Ls + 1e-12 * eye(len(cols)), Lt @ rho[..., None])[..., 0]

    # beta approximations N=1..3 (find_betas_approx_{1,2,3}, 674-742)
    b4 = lsq((0, 1, 3, 6))      # [b00, b01, b02, b03]
    s0 = torch.sign(b4[..., 0]) + (b4[..., 0] == 0).to(dt)
    r0 = torch.sqrt(torch.abs(b4[..., :1]))
    beta1 = torch.cat([r0, s0[..., None] * b4[..., 1:] / r0], dim=-1)
    b3 = lsq((0, 1, 2))         # [b00, b01, b11]
    zero = torch.zeros_like(b3[..., 0])
    b1_2 = torch.sqrt(torch.abs(b3[..., 0])) * torch.sign(b3[..., 1])
    b2_2 = torch.where(b3[..., 0] * b3[..., 2] > 0, torch.sqrt(torch.abs(b3[..., 2])), 0.0)
    beta2 = torch.stack([b1_2, b2_2, zero, zero], dim=-1)
    b5 = lsq((0, 1, 2, 3, 4))   # [b00, b01, b11, b02, b12]
    c1 = torch.sqrt(torch.abs(b5[..., 0])) * torch.sign(b5[..., 1])
    c2 = torch.where(b5[..., 0] * b5[..., 2] > 0, torch.sqrt(torch.abs(b5[..., 2])), 0.0)
    c3 = b5[..., 3] / torch.where(c1 == 0, 1.0, c1)
    beta3 = torch.stack([c1, c2, c3, zero], dim=-1)

    betas = torch.stack([beta1, beta2, beta3], dim=-2)                        # (..., 3, 4)
    ex = lambda a: a[..., None, :, :].expand(lead + (3,) + a.shape[-2:])  # noqa: E731
    b = _gauss_newton_betas(ex(L), ex(rho[..., None])[..., 0], betas)
    ccs = torch.einsum("...ci,...ijk->...cjk", b, vs)                       # (..., 3, 4, 3)
    pcs, ok_c = _finite(ex(alphas) @ ccs, 2)                                 # (..., 3, S, 3)
    flip = torch.where(pcs[..., 0, 2] < 0, -1.0, 1.0)                        # solve_for_sign
    Xe = ex(X)
    T = _horn_rt(Xe, pcs * flip[..., None, None])
    pc = Xe @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]
    uvp = pc[..., :2] / torch.clamp(pc[..., 2:3], min=1e-12)
    err = ((uvp - ex(uv_n)) ** 2).sum(dim=(-1, -2))
    good = torch.isfinite(err) & (pc[..., 2].amin(-1) > 0) & ok_c & ok[..., None]
    err = torch.where(good, err, float("inf"))
    best = torch.argmin(err, dim=-1)                                         # first minimum
    T = torch.gather(T, -3, best[..., None, None, None].expand(lead + (1, 4, 4)))[..., 0, :, :]
    return T.float()


def pnp_ransac(
    Xw: torch.Tensor,       # (N, 3) world points
    uv: torch.Tensor,       # (N, 2) observed pixels
    sigma2: torch.Tensor,   # (N,) octave variance
    valid: torch.Tensor,    # (N,) bool
    fx, fy, cx, cy,         # Python numbers
    idx: torch.Tensor,      # (n_hyp, sample_size) sample indices (sample_pnp)
    min_inliers: int = 10,
    solver: str = "epnp",
) -> PnPResult:
    """Score one hypothesis per row of `idx`: reprojection error below
    5.991 * sigma2 in front of the camera; the first hypothesis of the
    most inliers wins."""
    uv_n = torch.stack([numerics.div(uv[:, 0] - cx, fx), numerics.div(uv[:, 1] - cy, fy)], dim=1)
    hyp_solver = _epnp_pose if solver == "epnp" else _dlt_pose
    Ts = hyp_solver(Xw[idx], uv_n[idx])                                      # (H, 4, 4)
    pc = numerics.matmul(Xw[None], Ts[:, :3, :3].transpose(1, 2)) + Ts[:, None, :3, 3]
    z = pc[..., 2]
    zs = torch.clamp(z, min=1e-9)
    u = fx * pc[..., 0] / zs + cx
    v = fy * pc[..., 1] / zs + cy
    du = u - uv[None, :, 0]
    dv = v - uv[None, :, 1]
    e2 = du * du + dv * dv
    inl = (z > 0) & (e2 < 5.991 * sigma2[None]) & valid[None]
    counts = inl.sum(dim=1, dtype=torch.int32)
    best = torch.argmax(counts)
    return PnPResult(T=Ts[best], inliers=inl[best], n_inliers=counts[best],
                     ok=counts[best] >= min_inliers)
