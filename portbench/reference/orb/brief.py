"""Rotated BRIEF (rBRIEF) 256-bit descriptors.

Port of the parts of ``iv_slam_tpu/ops/brief.py`` that the frontend runs:
computeOrbDescriptor (ORBextractor.cc:108-148). For each keypoint the
512-point learned sampling pattern is rotated by the keypoint angle with
cvRound (round-half-even) integer snapping, and 256 brightness comparisons
are packed LSB-first into 32 bytes. ``descriptors_global_gather`` is the
plain version of the descriptor half of kernel 2 (``csrc/orient_brief.cu``).
The pattern table (brief_pattern.npy, a byte-for-byte copy of the JAX
package's) is OpenCV ORB's ``bit_pattern_31_`` learned pattern.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

_FACTOR_PI = np.float32(np.pi / 180.0)


@functools.lru_cache(maxsize=1)
def pattern() -> np.ndarray:
    """(512, 2) int32 sampling offsets (x, y)."""
    path = os.path.join(os.path.dirname(__file__), "brief_pattern.npy")
    return np.load(path).reshape(512, 2)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) bool -> (N, 32) uint8, LSB first."""
    weights = 1 << torch.arange(8, dtype=torch.int32, device=bits.device)
    return (bits.reshape(-1, 32, 8).to(torch.int32) * weights).sum(-1).to(torch.uint8)


def pattern_indices(h: int, w: int, yx: torch.Tensor,
                    angles_deg: torch.Tensor) -> torch.Tensor:
    """(N, 512) int64 flat indices into an (h, w) image of each keypoint's
    rotated pattern points. Rows are y + rint(x*sin + y*cos), columns
    x + rint(x*cos - y*sin), each product and sum rounded on its own (no
    FMA). Indices are clamped to the image, as jnp's gather clamps them."""
    dev = yx.device
    pat = torch.as_tensor(pattern(), dtype=torch.float32, device=dev)
    ang = angles_deg.to(torch.float32) * float(_FACTOR_PI)
    a = torch.cos(ang)[:, None]
    b = torch.sin(ang)[:, None]
    px, py = pat[None, :, 0], pat[None, :, 1]
    yx = yx.to(torch.int64)
    rows = torch.round(px * b + py * a).to(torch.int64) + yx[:, 0:1]
    cols = torch.round(px * a - py * b).to(torch.int64) + yx[:, 1:2]
    return torch.clamp(rows, 0, h - 1) * w + torch.clamp(cols, 0, w - 1)


def descriptors_global_gather(
    blurred: torch.Tensor, yx: torch.Tensor, angles_deg: torch.Tensor
) -> torch.Tensor:
    """Descriptors via one flat (N, 512) gather from the blurred image.

    blurred: (H, W) uint8 (7x7 sigma=2 Gaussian, as the reference);
    yx: (N, 2) int32 keypoint (row, col); angles_deg: (N,) float32.
    Returns (N, 32) uint8, bit i set when pattern point 2i is darker than
    point 2i+1 (``pattern_indices``).
    """
    flat_idx = pattern_indices(*blurred.shape, yx, angles_deg)
    vals = blurred.reshape(-1)[flat_idx]                     # (N, 512)
    return _pack_bits(vals[:, 0::2] < vals[:, 1::2])


def unpack_pm1(desc_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(N, 32) uint8 -> (N, 256) +-1 matrix (LSB-first bit order) for the
    matmul Hamming distance (see hamming.py)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=desc_u8.device)
    bits = (desc_u8[..., None] >> shifts) & 1
    bits = bits.reshape(*desc_u8.shape[:-1], 256)
    return (bits.to(torch.int8) * 2 - 1).to(dtype)
