"""Gaussian-process heatmap interpolation (feature_evaluator.cpp:1919-1976).

Port of ``iv_slam_tpu/ops/gp.py``. Sparse per-keypoint error scores are
interpolated into a dense "bad region heatmap" with GP regression: RBF
kernel (s_f = 80, l = 100), observation noise s_n = 20, evaluated at the
centers of 40x40 bins on a 20-px stride grid (feature_evaluator.h:390-393).

The reference's explicit matrix inverse becomes a Cholesky solve over a
fixed-capacity padded point set (cfg.gp.max_train_points), as in the JAX
package, which runs it with XLA's solvers (no Pallas kernel): here
``torch.linalg.cholesky_ex``, ``cholesky_solve`` and ``solve_triangular``
in float32. A kernel matrix that is not positive definite gives NaN
outputs, as ``jnp.linalg.cholesky`` does, and never raises or syncs.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .image import resize_bilinear


def grid_shape(img_h: int, img_w: int, bin_size: int = 40, stride: int = 20):
    bnx = int((img_w - bin_size) // stride) + 1
    bny = int((img_h - bin_size) // stride) + 1
    out_w = (bnx - 1) * stride + bin_size
    out_h = (bny - 1) * stride + bin_size
    return bny, bnx, out_h, out_w


def _rbf(a: torch.Tensor, b: torch.Tensor, s_f: float, ell: float) -> torch.Tensor:
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(dim=-1)
    return (s_f * s_f) * torch.exp(-d2 / (2.0 * ell * ell))


def _grid(bny: int, bnx: int, bin_size: int, stride: int, device, offset: float):
    """(G, 2) float32 (x, y) of the bin grid, row-major over (bny, bnx):
    bin origins (offset 0) or centers (offset bin_size / 2)."""
    gx = (torch.arange(bnx, device=device) * stride + offset).to(torch.float32)
    gy = (torch.arange(bny, device=device) * stride + offset).to(torch.float32)
    gyy, gxx = torch.meshgrid(gy, gx, indexing="ij")
    return torch.stack([gxx.reshape(-1), gyy.reshape(-1)], dim=-1)


def gp_grid_predict(
    points: torch.Tensor,   # (N, 2) keypoint (x, y), padded
    values: torch.Tensor,   # (N,) error values, padded
    valid: torch.Tensor,    # (N,) bool
    bny: int,
    bnx: int,
    bin_size: int = 40,
    stride: int = 20,
    s_f: float = 80.0,
    ell: float = 100.0,
    s_n: float = 20.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (mean, variance) over the (bny, bnx) bin grid."""
    n = points.shape[0]
    dev = points.device
    K = _rbf(points, points, s_f, ell)
    K = torch.where(valid[:, None] & valid[None, :], K, 0.0)
    # invalid rows/cols reduce to s_n^2 * e_i: harmless identity-like rows
    K = K + (s_n * s_n) * torch.eye(n, dtype=K.dtype, device=dev)
    L, info = torch.linalg.cholesky_ex(K)
    L = torch.where(info == 0, L, float("nan"))

    grid = _grid(bny, bnx, bin_size, stride, dev, bin_size / 2.0)   # (G, 2)
    Kv = torch.where(valid[None, :], _rbf(grid, points, s_f, ell), 0.0)  # (G, N)

    y = torch.where(valid, values, 0.0)
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    mean = Kv @ alpha  # (G,)

    # variance = s_f^2 - k*^T K^-1 k*
    W = torch.linalg.solve_triangular(L, Kv.T, upper=False)   # (N, G)
    var = (s_f * s_f) - (W * W).sum(dim=0)
    return mean.reshape(bny, bnx), var.reshape(bny, bnx)


def heatmap_from_grid(
    grid_vals: torch.Tensor,
    out_h: int,
    out_w: int,
    err_min: float = 0.0,
    err_max: float = 1.5,
) -> torch.Tensor:
    """GenerateErrHeatmap + resize + CV_8U conversion
    (feature_evaluator.cpp:3074-3112, 690-698): clamp-scale to [0, 1],
    bilinear-resize to the cropped image size, x255 -> uint8."""
    scaled = torch.clamp((grid_vals - err_min) / (err_max - err_min), 0.0, 1.0)
    up = resize_bilinear(scaled, out_h, out_w)
    return torch.clamp(torch.round(up * 255.0), 0, 255).to(torch.uint8)


def hist2d_heatmap(
    points: torch.Tensor,    # (N, 2) keypoint (x, y)
    values: torch.Tensor,    # (N,) error values
    valid: torch.Tensor,
    bny: int,
    bnx: int,
    bin_size: int = 40,
    stride: int = 20,
    err_min: float = 0.0,
) -> torch.Tensor:
    """Sliding-window histogram heatmap, the reference's non-GP variant
    (GenerateImageQualityHeatmap + Hist2D, fe.cpp:459-541, 3114-3181):
    each (bin_size x bin_size) window (stride-spaced) averages the error
    values of the keypoints inside it; empty bins default to err_min."""
    org = _grid(bny, bnx, bin_size, stride, points.device, 0.0)
    x0, y0 = org[:, 0:1], org[:, 1:2]
    px, py = points[None, :, 0], points[None, :, 1]
    inside = ((px >= x0) & (px < x0 + bin_size) & (py >= y0) & (py < y0 + bin_size)
              & valid[None, :]).to(torch.float32)
    freq = inside @ torch.ones_like(values)
    sums = inside @ torch.where(valid, values, 0.0)
    mean = torch.where(freq > 0, sums / torch.clamp(freq, min=1.0), err_min)
    return mean.reshape(bny, bnx)


def mask_from_variance(
    grid_var: torch.Tensor,
    out_h: int,
    out_w: int,
    var_max: float = 100.0,
    var_thresh: float = 0.5,
) -> torch.Tensor:
    """Unsupervised reliability mask (feature_evaluator.cpp:766-791):
    normalize variance by var_max, upscale, binary-inverse threshold at
    0.5 -> {0, 255} uint8 (255 = reliable)."""
    scaled = torch.clamp(grid_var / var_max, 0.0, 1.0)
    up = resize_bilinear(scaled, out_h, out_w)
    return torch.where(up > var_thresh, 0, 255).to(torch.uint8)
