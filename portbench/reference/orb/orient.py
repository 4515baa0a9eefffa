"""Keypoint orientation (intensity centroid) + OpenCV-exact fastAtan2.

Port of the parts of ``iv_slam_tpu/ops/orient.py`` that the frontend runs:
IC_Angle / computeOrientation (ORBextractor.cc:78-105, 478-487) as exact
integer moments from per-row prefix sums. ``ic_angles_integral`` is the
plain version of the orientation half of kernel 2
(``csrc/orient_brief.cu``, wrapped by ``ops/finish_cuda.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

HALF_PATCH = 15

# OpenCV fastAtan2 polynomial (degrees); accuracy ~0.3 deg — reproduced
# exactly so descriptor bit patterns match the reference's rotations.
_P1 = np.float32(0.9997878412794807 * (180.0 / np.pi))
_P3 = np.float32(-0.3258083974640975 * (180.0 / np.pi))
_P5 = np.float32(0.1555786518463281 * (180.0 / np.pi))
_P7 = np.float32(-0.04432655554792128 * (180.0 / np.pi))
_DBL_EPS = np.float32(2.220446049250313e-16)


def umax_table() -> np.ndarray:
    """Circular-patch row extents, symmetric (ORBextractor.cc:460-477)."""
    umax = np.zeros(HALF_PATCH + 1, dtype=np.int32)
    vmax = int(np.floor(HALF_PATCH * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(HALF_PATCH * np.sqrt(2.0) / 2))
    hp2 = HALF_PATCH * HALF_PATCH
    for v in range(vmax + 1):
        umax[v] = int(np.rint(np.sqrt(hp2 - v * v)))
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


@functools.lru_cache(maxsize=1)
def moment_weights() -> tuple:
    """(961,) u-weights and v-weights for the masked intensity centroid."""
    umax = umax_table()
    u = np.arange(-HALF_PATCH, HALF_PATCH + 1)
    uu, vv = np.meshgrid(u, u)  # vv rows, uu cols; signed coords
    mask = np.abs(uu) <= umax[np.abs(vv)]
    wu = (uu * mask).astype(np.float32).reshape(-1)
    wv = (vv * mask).astype(np.float32).reshape(-1)
    return wu, wv


@functools.lru_cache(maxsize=1)
def row_extents() -> np.ndarray:
    """(31,) circular-patch half-width per row offset v = -15..15."""
    umax = umax_table()
    v = np.arange(-HALF_PATCH, HALF_PATCH + 1)
    return umax[np.abs(v)].astype(np.int32)


def fast_atan2_deg(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """cv::fastAtan2 (degrees in [0, 360)), bit-faithful float32 math: every
    multiply and add is its own rounded f32 operation (no FMA), which the
    CUDA kernel reproduces with __fmul_rn / __fadd_rn."""
    ax, ay = torch.abs(x), torch.abs(y)
    c_lo = ay / (ax + float(_DBL_EPS))
    c_hi = ax / (ay + float(_DBL_EPS))
    c = torch.where(ax >= ay, c_lo, c_hi)
    c2 = c * c
    poly = (((float(_P7) * c2 + float(_P5)) * c2 + float(_P3)) * c2
            + float(_P1)) * c
    a = torch.where(ax >= ay, poly, 90.0 - poly)
    a = torch.where(x < 0, 180.0 - a, a)
    a = torch.where(y < 0, 360.0 - a, a)
    return a


def ic_angles_integral(img: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """IC orientation via per-row prefix sums — exact integer moments.

    img: (H, W) uint8; yx: (N, 2) int32 (row, col) at least 15 px from
    every border. For each row offset v the circular mask covers u in
    [-a, a] with a = umax[|v|], so with per-row prefix sums
    S(y, x) = sum_{x' <= x} I(y, x') and W(y, x) = sum_{x' <= x} x' I(y, x'):

      m01 = sum_v v * (S[y+v, x+a] - S[y+v, x-a-1])
      m10 = sum_v (W[y+v, x+a] - W[y+v, x-a-1]) - x * (S diff)

    Sums are int64 here (int32 in the reference, where they never exceed
    2^31), so the moments are the same integers. Gather indices are clamped:
    in-range for every keypoint the extractor emits, and memory-safe on the
    card for any input. Returns (N,) float32 degrees.
    """
    h, w = img.shape
    dev = img.device
    i64 = img.to(torch.int64)
    S = torch.nn.functional.pad(torch.cumsum(i64, dim=1), (1, 0))
    W = torch.nn.functional.pad(
        torch.cumsum(i64 * torch.arange(w, device=dev), dim=1), (1, 0))
    a = torch.as_tensor(row_extents(), dtype=torch.int64, device=dev)
    v = torch.arange(-HALF_PATCH, HALF_PATCH + 1, device=dev)
    yx = yx.to(torch.int64)
    rows = torch.clamp(yx[:, 0:1] + v[None, :], 0, h - 1)      # (N, 31)
    hi = torch.clamp(yx[:, 1:2] + a[None, :] + 1, 0, w)        # x + a (+1 pad)
    lo = torch.clamp(yx[:, 1:2] - a[None, :], 0, w)            # x - a - 1 (+1 pad)
    wp = w + 1
    Sf, Wf = S.reshape(-1), W.reshape(-1)
    s_diff = Sf[rows * wp + hi] - Sf[rows * wp + lo]
    w_diff = Wf[rows * wp + hi] - Wf[rows * wp + lo]
    m01 = torch.sum(v[None, :] * s_diff, dim=1)
    m10 = torch.sum(w_diff, dim=1) - yx[:, 1] * torch.sum(s_diff, dim=1)
    return fast_atan2_deg(m01.to(torch.float32), m10.to(torch.float32))
