"""Batched Sim(3) operations on torch tensors.

Port of ``iv_slam_tpu/geometry/sim3.py`` (g2o sim3.h equivalents). A Sim3
is stored as (R (3, 3), t (3,), s ()) with action x -> s R x + t. Tangent
vectors are 7-dim (omega, upsilon, sigma): rotation, translation, log-scale,
g2o's ordering for types_seven_dof_expmap edges.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import se3

_EPS = 1e-24


class Sim3(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor

    def act(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.as_tensor(self.s)[..., None]
        if x.ndim > self.t.ndim:  # (.., N, 3) points under unbatched Sim3
            s = s[..., None]
            t = self.t[..., None, :]
        else:
            t = self.t
        return s * (x @ self.R.transpose(-1, -2)) + t

    def compose(self, other: "Sim3") -> "Sim3":
        """self o other: (self * other)(x) = self(other(x))."""
        s = torch.as_tensor(self.s)[..., None]
        return Sim3(
            R=self.R @ other.R,
            t=s * (self.R @ other.t[..., None])[..., 0] + self.t,
            s=self.s * other.s,
        )

    def inverse(self) -> "Sim3":
        Rt = self.R.transpose(-1, -2)
        s_inv = 1.0 / self.s
        return Sim3(
            R=Rt,
            t=-torch.as_tensor(s_inv)[..., None] * (Rt @ self.t[..., None])[..., 0],
            s=s_inv,
        )

    @staticmethod
    def identity(dtype=torch.float32, device=None) -> "Sim3":
        return Sim3(torch.eye(3, dtype=dtype, device=device),
                    torch.zeros(3, dtype=dtype, device=device),
                    torch.tensor(1.0, dtype=torch.float32, device=device))

    @staticmethod
    def from_se3(T: torch.Tensor, s=None) -> "Sim3":
        return Sim3(
            T[..., :3, :3], T[..., :3, 3],
            torch.tensor(1.0, dtype=torch.float32, device=T.device) if s is None else s,
        )

    def to_se3(self) -> torch.Tensor:
        """Collapse to SE3 with t/s scaling (used when correcting map points
        after loop closure: [R, t/s])."""
        return se3.rt_to_mat(self.R, self.t / self.s)


def _calc_w(w: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The Sim3 left-Jacobian-like W matrix with t = W v (Strasdat's
    closed form): W = A W_hat + B W_hat^2 + C I."""
    theta2 = se3.sum3(w, w)
    theta = torch.sqrt(theta2 + _EPS)
    W = se3.hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    s = torch.exp(sigma)
    small_t = theta2 < 1e-4
    small_s = torch.abs(sigma) < 1e-3
    st, ct = torch.sin(theta), torch.cos(theta)
    one = torch.ones_like(theta2)
    sigma_safe = torch.where(small_s, one, sigma)
    theta_safe = torch.where(small_t, one, theta)
    theta2_safe = torch.where(small_t, one, theta2)
    c = theta2 + sigma * sigma
    c_safe = torch.where(c > _EPS, c, one)

    C = torch.where(small_s, one, (s - 1.0) / sigma_safe)
    # general case
    a_g = s * st
    b_g = s * ct
    A_gen = (a_g * sigma + (1.0 - b_g) * theta) / (theta_safe * c_safe)
    B_gen = (C - ((b_g - 1.0) * sigma + a_g * theta) / c_safe) / theta2_safe
    # sigma ~ 0 fallbacks
    A_s0 = (1.0 - ct) / theta2_safe
    B_s0 = (theta - st) / (theta2_safe * theta_safe)
    # theta ~ 0 fallbacks
    A_t0 = ((sigma - 1.0) * s + 1.0) / (sigma_safe * sigma_safe)
    B_t0 = (
        (0.5 * sigma * sigma - sigma + 1.0) * s - 1.0 - 0.5 * sigma * sigma
    ) / (sigma_safe ** 3)
    A = torch.where(small_t, torch.where(small_s, 0.5 * one, A_t0),
                    torch.where(small_s, A_s0, A_gen))
    B = torch.where(small_t, torch.where(small_s, one / 6.0, B_t0),
                    torch.where(small_s, B_s0, B_gen))
    return (
        A[..., None, None] * W
        + B[..., None, None] * W2
        + C[..., None, None] * eye
    )


def sim3_exp(xi: torch.Tensor) -> Sim3:
    """(..., 7) (omega, upsilon, sigma) -> Sim3 (Strasdat closed form, as
    g2o sim3.h)."""
    w, v, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    R = se3.so3_exp(w)
    Wmat = _calc_w(w, sigma)
    t = (Wmat @ v[..., None])[..., 0]
    return Sim3(R, t, torch.exp(sigma))


def sim3_log(S: Sim3) -> torch.Tensor:
    """Sim3 -> (..., 7). Inverse of sim3_exp via solving W xi_v = t."""
    w = se3.so3_log(S.R)
    sigma = torch.log(torch.as_tensor(S.s, device=w.device))
    sigma = sigma.expand(w.shape[:-1])
    Wmat = _calc_w(w, sigma)
    v = torch.linalg.solve(Wmat, S.t[..., None])[..., 0]
    return torch.cat([w, v, sigma[..., None]], dim=-1)


def jacobian7(f, xi: torch.Tensor) -> torch.Tensor:
    """Forward-mode Jacobian of a row-wise function of tangents: f maps
    (B, 7) to (B, ...), row b depending on xi[b] alone; returns (B, ..., 7)
    (``jax.jacfwd`` of the reference, vmapped over rows): one
    ``torch.func.jvp`` vmapped over the 7 coordinate directions, each set in
    every row at once. The primal stays batched over rows: torch's forward
    mode promotes the tangent of a 0-d float32 tensor combined with a
    Python number to float64."""
    basis = torch.eye(7, dtype=xi.dtype, device=xi.device)[:, None, :].expand(7, *xi.shape)
    cols = torch.func.vmap(lambda v: torch.func.jvp(f, (xi,), (v,))[1])(basis)
    return cols.movedim(0, -1)
