"""Bytes and operations of the frontend's three kernels a frame, each input
byte read once and each output byte written once:

  K1 fast_score: every pixel of every pyramid level of both images read
     (1 byte) and its int16 score written (2 bytes); 120 two-input
     operations a pixel (FAST_OPS_PER_PX);
  K2 orient_brief: the raw-canvas bytes the keypoints' circular patches
     reach and the blurred-canvas bytes their rotated pattern points reach
     (distinct bytes), the keypoints, the outputs and the tables; moments
     3 operations a masked pixel, rBRIEF 6 a pattern point and 2 a bit;
  K3 sad_windows: the distinct bytes of the 11x11 left windows and 11x21
     right strips, the centres and the (N, 11) output; 11 x 121 x 4
     operations a keypoint.
"""

from __future__ import annotations

import numpy as np
import torch

# the 16 circular 9-window minima and maxima, 42 each; 15 maxima of the
# minima and 15 minima of the maxima; 2 differences with the centre; max,
# -1, compare, select
FAST_OPS_PER_PX = 2 * 42 + 2 * 15 + 2 + 4
# the circular patch (HALF_PATCH 15): umax extents of ORBextractor.cc:441-456
HALF_PATCH = 15
SAD_HALF, SAD_SLIDE = 5, 5


def row_extents() -> np.ndarray:
    """The patch's half-width of each of its 31 rows."""
    hp = HALF_PATCH
    umax = np.zeros(hp + 1, np.int32)
    vmax = int(np.floor(hp * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(hp * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(np.round(np.sqrt(hp * hp - v * v)))
    v0 = 0
    for v in range(hp, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return np.concatenate([umax[::-1], umax[1:]])


def fast_counts(level_shapes, images: int = 2):
    """(bytes, operations) of K1 over the levels' (h, w) of `images` images."""
    px = images * sum(h * w for h, w in level_shapes)
    return 3 * px, px * FAST_OPS_PER_PX


def orient_brief_counts(n: int, raw_bytes: int, blur_bytes: int):
    ops = 3 * int(np.sum(2 * row_extents() + 1)) + 512 * 6 + 256 * 2
    return raw_bytes + blur_bytes + n * 2 * 4 + n * (4 + 32) + 512 * 2 + 31 * 4, n * ops


def sad_counts(n: int, left_bytes: int, right_bytes: int):
    return left_bytes + right_bytes + 3 * n * 4 + n * 11 * 4, n * 11 * 121 * 4


def touched(shape, flat_idx: torch.Tensor) -> int:
    """Distinct elements of a canvas of `shape` that the flat indices reach."""
    seen = torch.zeros(int(np.prod(shape)), dtype=torch.bool, device=flat_idx.device)
    seen[flat_idx.reshape(-1)] = True
    return int(seen.sum())


def window_indices(shape, yc, xc, half_h: int, half_w: int) -> torch.Tensor:
    """(N, (2 half_h + 1)(2 half_w + 1)) flat indices of the windows centred
    at (yc, xc), clamped to the canvas."""
    R, C = shape
    dev = yc.device
    rows = (yc.long()[:, None] + torch.arange(-half_h, half_h + 1, device=dev)).clamp(0, R - 1)
    cols = (xc.long()[:, None] + torch.arange(-half_w, half_w + 1, device=dev)).clamp(0, C - 1)
    return (rows[:, :, None] * C + cols[:, None, :]).reshape(len(yc), -1)


def frame_counts(level_shapes, raw_shape, yx, pattern_idx, sad_shape, yc, xl, xr):
    """{kernel: (bytes, operations)} of one stereo frame: ``yx`` the (N, 2)
    canvas coordinates K2 describes on canvases of ``raw_shape``,
    ``pattern_idx`` the flat blurred-canvas indices its rotated pattern
    points read, and (yc, xl, xr) the centres K3 slides over canvases of
    ``sad_shape``."""
    ext = torch.as_tensor(row_extents(), device=yx.device)
    hp = HALF_PATCH
    square = window_indices(raw_shape, yx[:, 0], yx[:, 1], hp, hp)
    circle = (torch.arange(-hp, hp + 1, device=yx.device)[None, :].abs()
              <= ext[:, None]).reshape(-1)
    raw_b = touched(raw_shape, square[:, circle])
    blur_b = touched(raw_shape, pattern_idx)
    w, ll = SAD_HALF, SAD_SLIDE
    left_b = touched(sad_shape, window_indices(sad_shape, yc, xl, w, w))
    right_b = touched(sad_shape, window_indices(sad_shape, yc, xr, w, w + ll))
    return dict(fast_score=fast_counts(level_shapes),
                orient_brief=orient_brief_counts(len(yx), raw_b, blur_b),
                sad_windows=sad_counts(len(yc), left_b, right_b))
