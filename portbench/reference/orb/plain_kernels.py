"""The three per-frame image kernels of the ORB frontend in plain PyTorch:
FAST scores of every pyramid level, IC angles + rBRIEF on the flattened
canvas, and the stereo SAD slide. Each is the straightforward formulation
(fast.py, orient.py + brief.py, the dynamic-slice SAD below)."""

from __future__ import annotations

from typing import List

import torch

from . import brief, fast, orient

_W = 5          # SAD half-window
_L = 5          # slide half-range
_WIN = 2 * _W + 1


def fast_score_levels(levels: List[torch.Tensor], threshold: int) -> List[torch.Tensor]:
    """int16 FAST score map (no NMS) of each (B, h, w) uint8 level."""
    return [fast.fast_score(lv, threshold) for lv in levels]


def orient_brief(raw: torch.Tensor, blur: torch.Tensor, yx: torch.Tensor):
    """(angles (N,) float32 degrees, descriptors (N, 32) uint8) of the
    keypoints at canvas coordinates yx (N, 2) int32."""
    ang = orient.ic_angles_integral(raw, yx)
    return ang, brief.descriptors_global_gather(blur, yx, ang)


def sad_windows(canvas_l: torch.Tensor, canvas_r: torch.Tensor,
                yc: torch.Tensor, xl: torch.Tensor, xr: torch.Tensor) -> torch.Tensor:
    """(N, 11) float32 SAD of the 11x11 left patch at (yc, xl) against each
    11x11 window of the 11x21 right strip at (yc, xr), both centred on
    their own middle pixel. Integer values, exact in float32 in any
    summation order."""
    dev = canvas_l.device
    r = torch.arange(-_W, _W + 1, device=dev)
    s = torch.arange(-_W - _L, _W + _L + 1, device=dev)
    rows = yc.to(torch.int64)[:, None, None] + r[None, :, None]
    IL = canvas_l[rows, xl.to(torch.int64)[:, None, None] + r[None, None, :]]
    IR = canvas_r[rows, xr.to(torch.int64)[:, None, None] + s[None, None, :]]
    IL = IL.to(torch.float32)
    IR = IR.to(torch.float32)
    IL = IL - IL[:, _W, _W][:, None, None]
    out = []
    for inc in range(2 * _L + 1):
        win = IR[:, :, inc:inc + _WIN]
        win = win - win[:, _W, _W][:, None, None]
        out.append(torch.sum(torch.abs(IL - win), dim=(1, 2)))
    return torch.stack(out, dim=1)
