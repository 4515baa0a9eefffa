"""FAST-9/16 corner scoring, plain PyTorch version.

Port of ``iv_slam_tpu/ops/fast.py``. This is the plain version of kernel 1
(``csrc/fast_score.cu``, wrapped by ``ops/fast_cuda.py``): the CPU tests
hold it against the JAX package, and the chip check holds the kernel
against it. Dense and branch-free over whole levels:

  1. 16 circle samples per pixel via shifted copies,
  2. "9 consecutive of 16" arc test via a log-step circular min-reduction,
  3. OpenCV-compatible corner score (max threshold keeping the corner),
  4. 3x3 non-max suppression as an elementwise max compare.
"""

from __future__ import annotations

import numpy as np
import torch

# Bresenham circle of radius 3, in circular order, as (dy, dx) (OpenCV
# makeOffsets ordering; any rotation of this ring is detection-equivalent).
CIRCLE = np.array(
    [
        (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    ],
    dtype=np.int32,
)


def _circle_diffs(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W) uint8 -> (16, ..., H, W) int16 diffs circle[i] - center.

    Shifted copies wrap around; the 3-pixel border they corrupt is masked
    by the caller (cv::FAST likewise ignores a 3-pixel border). The cast
    comes before the subtraction: uint8 differences would wrap.
    """
    center = img.to(torch.int16)
    return torch.stack([
        torch.roll(center, shifts=(-int(dy), -int(dx)), dims=(-2, -1)) - center
        for dy, dx in CIRCLE
    ])


def _circular_min9(d: torch.Tensor) -> torch.Tensor:
    """out[i] = min(d[i], ..., d[i+8]) circularly over the leading 16 axis."""
    m1 = torch.minimum(d, torch.roll(d, -1, 0))       # window 2
    m2 = torch.minimum(m1, torch.roll(m1, -2, 0))     # window 4
    m4 = torch.minimum(m2, torch.roll(m2, -4, 0))     # window 8
    return torch.minimum(m4, torch.roll(d, -8, 0))    # window 9


def fast_score(img: torch.Tensor, threshold: int) -> torch.Tensor:
    """FAST-9/16 corner response map, OpenCV semantics.

    img: (..., H, W) uint8. Returns (..., H, W) int16: 0 where not a corner
    at `threshold`, else the corner score (the maximal threshold at which
    the segment test still passes, minus 1 — cv::FAST's cornerScore<16>
    with K=8). A 3-pixel border is always 0.
    """
    h, w = img.shape[-2], img.shape[-1]
    d = _circle_diffs(img)
    bscore = _circular_min9(d).amax(0)      # best bright arc
    dscore = _circular_min9(-d).amax(0)     # best dark arc
    score = torch.maximum(bscore, dscore) - 1
    is_corner = score >= threshold
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    interior = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    return torch.where(is_corner & interior, score, 0).to(torch.int16)


def nonmax_suppress(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression: keep strictly-greater-than-neighbors maxima
    (cv::FAST(nonmaxSuppression=true); ties suppressed on both sides)."""
    s = score.to(torch.int16)
    nmax = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            n = torch.roll(s, shifts=(dy, dx), dims=(-2, -1))
            nmax = n if nmax is None else torch.maximum(nmax, n)
    return torch.where(s > nmax, s, 0)
