"""Pinhole/stereo camera projection math on torch tensors.

Port of ``iv_slam_tpu/geometry/camera.py``. Stereo observations follow the
reference convention: ``(u_left, v_left, u_right)`` with
``u_right = u_left - bf / z``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Intrinsics(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    bf: torch.Tensor  # baseline * fx

    @staticmethod
    def from_config(cam, device=None) -> "Intrinsics":
        """0-d float32 tensors on `device` from a CameraConfig."""
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
        return Intrinsics(f32(cam.fx), f32(cam.fy), f32(cam.cx), f32(cam.cy),
                          f32(cam.bf))


def project(K: Intrinsics, pts_cam: torch.Tensor) -> torch.Tensor:
    """(..., 3) camera-frame points -> (..., 2) pixels."""
    z = pts_cam[..., 2]
    invz = 1.0 / z
    u = K.fx * pts_cam[..., 0] * invz + K.cx
    v = K.fy * pts_cam[..., 1] * invz + K.cy
    return torch.stack([u, v], dim=-1)


def project_stereo(K: Intrinsics, pts_cam: torch.Tensor) -> torch.Tensor:
    """(..., 3) camera-frame points -> (..., 3) [u_l, v_l, u_r]."""
    uv = project(K, pts_cam)
    ur = uv[..., 0] - K.bf / pts_cam[..., 2]
    return torch.cat([uv, ur[..., None]], dim=-1)


def backproject(K: Intrinsics, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) + depth (...,) -> camera-frame points (..., 3)."""
    x = (uv[..., 0] - K.cx) * depth / K.fx
    y = (uv[..., 1] - K.cy) * depth / K.fy
    return torch.stack([x, y, depth], dim=-1)


def disparity_to_depth(K: Intrinsics, disparity: torch.Tensor) -> torch.Tensor:
    return K.bf / torch.clamp(disparity, min=1e-6)


def _proj_rows(K: Intrinsics, pc: torch.Tensor):
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    invz = 1.0 / z
    invz2 = invz * invz
    zeros = torch.zeros_like(x)
    row_u = torch.stack([K.fx * invz, zeros, -K.fx * x * invz2], dim=-1)
    row_v = torch.stack([zeros, K.fy * invz, -K.fy * y * invz2], dim=-1)
    return x, invz, invz2, zeros, row_u, row_v


def proj_jacobian_mono(K: Intrinsics, pc: torch.Tensor) -> torch.Tensor:
    """d(u,v)/d(pc): (..., 3) camera points -> (..., 2, 3)."""
    *_, row_u, row_v = _proj_rows(K, pc)
    return torch.stack([row_u, row_v], dim=-2)


def proj_jacobian_stereo(K: Intrinsics, pc: torch.Tensor) -> torch.Tensor:
    """d(u_l,v_l,u_r)/d(pc): (..., 3) -> (..., 3, 3)."""
    x, invz, invz2, zeros, row_u, row_v = _proj_rows(K, pc)
    row_r = torch.stack(
        [K.fx * invz, zeros, -K.fx * x * invz2 + K.bf * invz2], dim=-1
    )
    return torch.stack([row_u, row_v, row_r], dim=-2)


def undistort_points(
    pts: torch.Tensor,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    dist,
    iterations: int = 5,
) -> torch.Tensor:
    """Iterative undistortion of (..., 2) pixel points (cv::undistortPoints
    semantics with k1,k2,p1,p2,k3; Frame.cc:696-737 UndistortKeyPoints).
    `dist`: the five coefficients, a sequence or a tensor."""
    k1, k2, p1, p2, k3 = (dist[i] for i in range(5))
    x0 = (pts[..., 0] - cx) / fx
    y0 = (pts[..., 1] - cy) / fy
    x, y = x0, y0
    for _ in range(iterations):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (x0 - dx) / radial
        y = (y0 - dy) / radial
    return torch.stack([x * fx + cx, y * fy + cy], dim=-1)
