"""Hamming distance between 256-bit ORB descriptors as one matmul.

Port of ``iv_slam_tpu/ops/hamming.py::hamming_matrix``. With bits mapped
to s in {-1, +1}, <s_a, s_b> = 256 - 2 * hamming(a, b), so the whole
N x M distance matrix is one float32 matmul of the +-1 expansions. Every
partial sum is an integer of magnitude <= 256, exact in float32 in any
order, so the result is exact as long as TF32 is off (the package turns
it off on import).
"""

from __future__ import annotations

import torch

from .brief import unpack_pm1

BITS = 256


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(..., N, 32) u8, (..., M, 32) u8 -> (..., N, M) int32 Hamming
    distances (leading axes broadcast)."""
    a = unpack_pm1(desc_a, torch.float32)
    b = unpack_pm1(desc_b, torch.float32)
    dot = (a @ b.transpose(-1, -2)).to(torch.int32)
    return (BITS - dot) // 2
