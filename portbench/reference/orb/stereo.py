"""Stereo keypoint matching (Frame::ComputeStereoMatches, Frame.cc:758-932):

  1. full left x right Hamming matrix, masked by the epipolar row band
     (|row(vL) - vR| <= 2 * scale^octaveR), +-1 octave agreement and the
     disparity window [uL - bf/fx_b, uL] -> masked argmin;
  2. sub-pixel refinement: 11x11 SAD over a +-5 px slide at the keypoint's
     pyramid level, parabola fit, all levels read from one flattened
     pyramid canvas;
  3. median-SAD outlier rejection (dist < 1.5 * 1.4 * median).

Returns per-left-keypoint (u_right, depth), -1 where unmatched.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .hamming import hamming_matrix
from .plain_kernels import _L, _W, sad_windows  # SAD half-window, slide half-range

TH_HIGH = 100
TH_LOW = 50


def flatten_pyramid(levels: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, np.ndarray]:
    """Stack variable-size levels into one (..., sum_h, w0) canvas.

    Returns (canvas, row_offsets[n_levels]) — a keypoint at native-level
    (y, x), octave l lives at canvas row offsets[l] + y. Levels may carry
    leading batch dims; each is zero-padded on the right to w0.
    """
    w0 = levels[0].shape[-1]
    padded = [F.pad(lv, (0, w0 - lv.shape[-1])) for lv in levels]
    offsets = np.cumsum([0] + [lv.shape[-2] for lv in levels[:-1]])
    return torch.cat(padded, dim=-2), offsets


def match_stereo(
    kpL_xy: torch.Tensor,      # (N, 2) level-0 float (u, v)
    kpL_oct: torch.Tensor,     # (N,) int32
    kpL_desc: torch.Tensor,    # (N, 32) u8
    kpL_valid: torch.Tensor,   # (N,) bool
    kpR_xy: torch.Tensor,      # (M, 2)
    kpR_oct: torch.Tensor,
    kpR_desc: torch.Tensor,
    kpR_valid: torch.Tensor,
    canvasL: torch.Tensor,     # (sum_h, w0) flattened left pyramid, uint8
    canvasR: torch.Tensor,     # flattened right pyramid
    level_offsets: torch.Tensor,   # (n_levels,) int32 canvas row offsets
    level_widths: torch.Tensor,    # (n_levels,) int32 native level widths
    scale_factors: torch.Tensor,   # (n_levels,) float32
    bf: float,                     # baseline * fx
    min_z: float,                  # baseline (minZ = mb)
    record: dict = None,           # receives the SAD slide's centres
) -> Tuple[torch.Tensor, torch.Tensor]:
    n = kpL_xy.shape[0]
    dev = kpL_xy.device
    th_orb = (TH_HIGH + TH_LOW) // 2
    # f32 scalars on the device (torch.full rounds like np.float32; a host
    # tensor would need an upload and a stream sync)
    bf_t = torch.full((), bf, dtype=torch.float32, device=dev)
    min_z_t = torch.full((), min_z, dtype=torch.float32, device=dev)
    kpL_oct = kpL_oct.to(torch.int64)
    kpR_oct = kpR_oct.to(torch.int64)

    # --- stage 1: banded Hamming argmin -----------------------------------
    dist = hamming_matrix(kpL_desc, kpR_desc)  # (N, M)
    uL = kpL_xy[:, 0][:, None]
    vL_row = torch.floor(kpL_xy[:, 1])[:, None]
    uR = kpR_xy[:, 0][None, :]
    vR = kpR_xy[:, 1][None, :]
    r_band = 2.0 * scale_factors[kpR_oct][None, :]
    in_band = (vL_row >= torch.floor(vR - r_band)) & (vL_row <= torch.ceil(vR + r_band))
    oct_ok = torch.abs(kpR_oct[None, :] - kpL_oct[:, None]) <= 1
    max_d = bf_t / min_z_t
    disp_ok = (uR >= uL - max_d) & (uR <= uL)
    mask = in_band & oct_ok & disp_ok & kpL_valid[:, None] & kpR_valid[None, :]
    masked = torch.where(mask, dist, 1 << 20)
    best_r = torch.argmin(masked, dim=1)          # first minimum, as jnp
    best_d = masked.gather(1, best_r[:, None])[:, 0]
    cand_ok = best_d < th_orb

    # --- stage 2: SAD sub-pixel refinement --------------------------------
    sf_l = scale_factors[kpL_oct]
    inv_scale = torch.reciprocal(sf_l)            # == 1.0 / sf, IEEE-rounded
    su_l = torch.round(kpL_xy[:, 0] * inv_scale).to(torch.int32)
    sv_l = torch.round(kpL_xy[:, 1] * inv_scale).to(torch.int32)
    uR0 = kpR_xy[best_r, 0]
    su_r0 = torch.round(uR0 * inv_scale).to(torch.int32)
    lw = level_widths[kpL_oct]
    off = level_offsets[kpL_oct]

    # reference bounds check (Frame.cc:867-870) + memory-safety guards
    bounds_ok = (su_r0 + _L + _W + 1 < lw) & (su_r0 - _L - _W >= 0)
    safe = cand_ok & bounds_ok
    yc = torch.clamp(off + sv_l, _W, canvasL.shape[0] - _W - 1).to(torch.int32)
    xl = torch.clamp(su_l, _W, canvasL.shape[1] - _W - 1).to(torch.int32)
    xr = torch.clamp(su_r0, _W + _L, canvasR.shape[1] - _W - _L - 1).to(torch.int32)

    if record is not None:
        record["sad_centres"] = (yc, xl, xr)
    dists = sad_windows(canvasL, canvasR, yc, xl, xr)  # (N, 11)
    best_inc = torch.argmin(dists, dim=1)
    interior = (best_inc > 0) & (best_inc < 2 * _L)
    bi = torch.clamp(best_inc, 1, 2 * _L - 1)
    d1 = dists.gather(1, bi[:, None] - 1)[:, 0]
    d2 = dists.gather(1, bi[:, None])[:, 0]
    d3 = dists.gather(1, bi[:, None] + 1)[:, 0]
    denom = d1 + d3 - 2.0 * d2
    delta = (d1 - d3) / torch.where(torch.abs(denom) > 0, 2.0 * denom, 1.0)
    delta_ok = (delta >= -1.0) & (delta <= 1.0) & (torch.abs(denom) > 0)

    best_ur = sf_l * (su_r0.to(torch.float32) + (bi - _L).to(torch.float32) + delta)
    disparity = kpL_xy[:, 0] - best_ur
    disp_in_range = (disparity >= 0.0) & (disparity < max_d)
    clamp0 = disparity <= 0.0
    disparity = torch.where(clamp0, 0.01, disparity)
    best_ur = torch.where(clamp0, kpL_xy[:, 0] - 0.01, best_ur)

    ok = safe & interior & delta_ok & disp_in_range
    sad_best = d2

    # --- stage 3: median-SAD outlier cut (Frame.cc:918-931) ---------------
    sorted_sad = torch.sort(torch.where(ok, sad_best, float("inf"))).values
    cnt = torch.sum(ok.to(torch.int64))
    median = sorted_sad.gather(0, torch.clamp(cnt // 2, 0, n - 1).reshape(1))[0]
    ok = ok & (sad_best < 1.5 * 1.4 * median)

    u_right = torch.where(ok, best_ur, -1.0)
    depth = torch.where(ok, bf_t / disparity, -1.0)
    return u_right, depth
