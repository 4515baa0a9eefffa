"""Dense image ops: bilinear resize, Gaussian blur, reflected borders.

Port of ``iv_slam_tpu/ops/image.py``: the cv::resize / cv::GaussianBlur /
cv::copyMakeBorder calls of the reference's pyramid builder
(ORBextractor.cc:1298-1323) and descriptor pre-blur (ORBextractor.cc:1277),
over (H, W) or (B, H, W) tensors. Float math with a final round-half-even,
as the JAX package does (not OpenCV's fixed point), and the same summation
order, so results equal the JAX package's bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv2.resize(..., INTER_LINEAR) semantics: half-pixel centers, edge clamp.

    img: (..., H, W) float32 or uint8; returns same dtype (uint8 rounded).
    """
    in_h, in_w = img.shape[-2], img.shape[-1]
    dev = img.device
    x = img.to(torch.float32)

    scale_y = in_h / out_h
    scale_x = in_w / out_w
    sy = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) * scale_y - 0.5
    sx = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) * scale_x - 0.5
    y0 = torch.clamp(torch.floor(sy), 0, in_h - 1).to(torch.int64)
    x0 = torch.clamp(torch.floor(sx), 0, in_w - 1).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=in_h - 1)
    x1 = torch.clamp(x0 + 1, max=in_w - 1)
    wy = torch.clamp(sy - y0.to(torch.float32), 0.0, 1.0)
    wx = torch.clamp(sx - x0.to(torch.float32), 0.0, 1.0)

    top = x[..., y0, :]
    bot = x[..., y1, :]
    rows = top * (1.0 - wy)[:, None] + bot * wy[:, None]
    left = rows[..., :, x0]
    right = rows[..., :, x1]
    out = left * (1.0 - wx) + right * wx
    if not img.dtype.is_floating_point:
        out = torch.clamp(torch.round(out), 0, 255).to(img.dtype)
    return out


@functools.lru_cache(maxsize=64)
def _reflect_index(n: int, pad: int, device: torch.device) -> torch.Tensor:
    """Source indices of a BORDER_REFLECT_101 pad (gfedcb|abcdefgh|gfedcba),
    cached per device: an upload from pageable memory on every call would
    synchronise the stream and stall a queued frame."""
    i = np.abs(np.arange(-pad, n + pad))
    i = np.where(i >= n, 2 * (n - 1) - i, i)
    return torch.as_tensor(i, dtype=torch.int64, device=device)


def reflect101_pad(img: torch.Tensor, pad: int) -> torch.Tensor:
    """cv::BORDER_REFLECT_101 padding on the last 2 dims (equals jnp.pad
    mode="reflect"); any number of leading dims."""
    h, w = img.shape[-2], img.shape[-1]
    out = img.index_select(-2, _reflect_index(h, pad, img.device))
    return out.index_select(-1, _reflect_index(w, pad, img.device))


@functools.lru_cache(maxsize=8)
def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel semantics (float64, normalized), as float32."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    r = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(r * r) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur with BORDER_REFLECT_101 (cv2.GaussianBlur).

    img: (..., H, W); uint8 in -> uint8 out (rounded). The sums run in the
    JAX package's order, sum(k[i] * slice_i) from 0, so f32 rounding agrees.
    """
    k = [float(v) for v in gaussian_kernel_1d(ksize, sigma)]
    pad = ksize // 2
    h, w = img.shape[-2], img.shape[-1]
    x = reflect101_pad(img.to(torch.float32), pad)
    xh = sum(k[i] * x[..., pad:pad + h, i:i + w] for i in range(ksize))
    xh_p = xh.index_select(-2, _reflect_index(h, pad, img.device))
    out = sum(k[i] * xh_p[..., i:i + h, :] for i in range(ksize))
    if not img.dtype.is_floating_point:
        out = torch.clamp(torch.round(out), 0, 255).to(img.dtype)
    return out
