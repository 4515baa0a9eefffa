"""Batched SO(3)/SE(3) operations on torch tensors.

Port of ``iv_slam_tpu/geometry/se3.py``. Poses are (..., 4, 4) homogeneous
matrices or (..., 6) tangent vectors with the g2o convention
``xi = (omega, upsilon)``: rotation first, translation second. The small-angle
Taylor branches are ``torch.where`` selections, as in the reference, so no
function branches on a value on the host.

Sums of three products are written out as ``(a + b) + c``, the order in
which XLA reduces a 3-element axis; matrix products, roots, sines and
divisions by constants go through ``numerics``, so every function rounds
alike on the CPU and on the GPU.
"""

from __future__ import annotations

import torch

from .. import numerics

_EPS = 1e-24  # only guards exact-zero division; Taylor handles small angles


def sum3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> over the last axis of (..., 3) tensors, summed left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of (..., 3) vectors -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def _rodrigues_coeffs(theta2: torch.Tensor):
    """A = sin(t)/t, B = (1 - cos(t))/t^2 with their Taylor branches."""
    theta = numerics.sqrt(theta2 + _EPS)
    use_taylor = theta2 < 1e-4
    A = torch.where(use_taylor, 1.0 - numerics.div(theta2, 6.0),
                    numerics.sin(theta) / theta)
    B = torch.where(use_taylor, 0.5 - numerics.div(theta2, 24.0),
                    (1.0 - numerics.cos(theta)) / theta2)
    return A, B, use_taylor


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: (..., 3) -> (..., 3, 3). Stable near zero."""
    theta2 = sum3(w, w)[..., None, None]
    W = hat(w)
    W2 = numerics.matmul(W, W)
    A, B, _ = _rodrigues_coeffs(theta2)
    return _eye_like(W) + A * W + B * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) axis-angle. Accurate for angles < pi.

    theta comes from arctan2(|vee|/2, cos) rather than arccos, as in the
    reference (whose derivative at the identity this keeps finite)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    vee = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin2 = 0.25 * sum3(vee, vee)
    sin_t = numerics.sqrt(sin2 + _EPS)
    theta = numerics.atan2(sin_t, cos_t)
    small = sin2 < 1e-12
    scale = torch.where(
        small,
        0.5 + numerics.div(theta * theta, 12.0),
        theta / (2.0 * torch.where(small, torch.ones_like(sin_t), sin_t)),
    )
    return vee * scale[..., None]


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential map: (..., 6) tangent (omega, upsilon) -> (..., 4, 4)."""
    w, v = xi[..., :3], xi[..., 3:]
    theta2 = sum3(w, w)[..., None, None]
    W = hat(w)
    W2 = numerics.matmul(W, W)
    eye = _eye_like(W)
    A, B, use_taylor = _rodrigues_coeffs(theta2)
    C = torch.where(use_taylor, 1.0 / 6.0 - numerics.div(theta2, 120.0), (1.0 - A) / theta2)
    R = eye + A * W + B * W2
    V = eye + B * W + C * W2
    t = numerics.matmul(V, v[..., None])[..., 0]
    return rt_to_mat(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) log map: (..., 4, 4) -> (..., 6) tangent (omega, upsilon)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta2 = sum3(w, w)[..., None, None]
    W = hat(w)
    W2 = numerics.matmul(W, W)
    A, B, use_taylor = _rodrigues_coeffs(theta2)
    # V^{-1} = I - W/2 + (1/theta^2)(1 - A/(2B)) W^2
    D = torch.where(
        use_taylor,
        1.0 / 12.0 + numerics.div(theta2, 720.0),
        (1.0 - A / (2.0 * B)) / theta2,
    )
    Vinv = _eye_like(W) - 0.5 * W + D * W2
    v = numerics.matmul(Vinv, t[..., None])[..., 0]
    return torch.cat([w, v], dim=-1)


def rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) from (..., 3, 3) and (..., 3)."""
    # [0, 0, 0, 1] built without an element store: storing a Python number
    # into a CUDA tensor waits for the device
    lead = R.shape[:-2] + (1,)
    bottom = torch.cat([R.new_zeros(lead + (3,)), R.new_ones(lead + (1,))], dim=-1)
    return torch.cat([torch.cat([R, t[..., None]], dim=-1), bottom], dim=-2)


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 4, 4) rigid transforms."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return rt_to_mat(Rt, -numerics.matmul(Rt, t[..., None])[..., 0])


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (4, 4) (or batched) transform to (..., N, 3) points."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return numerics.matmul(pts, R.transpose(-1, -2)) + t[..., None, :]


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) [x, y, z, w] -> rotation matrix (..., 3, 3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) [x, y, z, w].

    Branch-free Shepperd's method: all four candidates computed, the one of
    the largest pivot selected (first index among equal pivots, as
    ``jnp.argmax``)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    pivots = torch.stack(
        [
            1.0 + tr,
            1.0 + m00 - m11 - m22,
            1.0 - m00 + m11 - m22,
            1.0 - m00 - m11 + m22,
        ],
        dim=-1,
    )
    S = 2.0 * numerics.sqrt(torch.clamp(pivots, min=_EPS))  # (..., 4)
    s0, s1, s2, s3 = S[..., 0], S[..., 1], S[..., 2], S[..., 3]
    cand = torch.stack(
        [
            torch.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0, s0 / 4],
                        dim=-1),
            torch.stack([s1 / 4, (m01 + m10) / s1, (m02 + m20) / s1, (m21 - m12) / s1],
                        dim=-1),
            torch.stack([(m01 + m10) / s2, s2 / 4, (m12 + m21) / s2, (m02 - m20) / s2],
                        dim=-1),
            torch.stack([(m02 + m20) / s3, (m12 + m21) / s3, s3 / 4, (m10 - m01) / s3],
                        dim=-1),
        ],
        dim=-2,
    )  # (..., 4 candidates, 4 [x,y,z,w])
    best = torch.argmax(pivots, dim=-1)
    q = torch.take_along_dim(cand, best[..., None, None], dim=-2)[..., 0, :]
    q = q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)
    return q / numerics.sqrt(q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1]
                          + q[..., 2] * q[..., 2] + q[..., 3] * q[..., 3])[..., None]
