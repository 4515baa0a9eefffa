"""Scale pyramid construction (ORBextractor.cc:1298-1360 semantics).

Port of ``iv_slam_tpu/ops/pyramid.py``. Level sizes are
cvRound(orig_size * scale^-level) on the cumulative float32 scale; each
level is a bilinear resize of the previous level (not of level 0). Levels
are stored unpadded.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .image import resize_bilinear


def pyramid_shapes(
    height: int, width: int, scale_factor: float, n_levels: int
) -> List[Tuple[int, int]]:
    """Static per-level (h, w), matching cvRound(orig * scale^-level)."""
    shapes = []
    scale = np.float32(1.0)  # cumulative f32 product, as the reference stores it
    for lvl in range(n_levels):
        if lvl > 0:
            scale = np.float32(scale * np.float32(scale_factor))
        inv = np.float32(1.0) / scale
        h = int(np.rint(np.float32(height) * inv))
        w = int(np.rint(np.float32(width) * inv))
        shapes.append((h, w))
    return shapes


def build_pyramid(
    img: torch.Tensor, shapes: Sequence[Tuple[int, int]]
) -> List[torch.Tensor]:
    """img: (..., H, W) -> list of per-level (..., h_l, w_l), chained resizes."""
    levels = [img]
    for h, w in shapes[1:]:
        levels.append(resize_bilinear(levels[-1], h, w))
    return levels
