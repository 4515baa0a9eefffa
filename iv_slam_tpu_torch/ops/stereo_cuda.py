"""Wrapper of kernel 3, ``csrc/sad_windows.cu``: stereo SAD slides.

Replaces ``iv_slam_tpu/ops/stereo_pallas.py::sad_windows_pallas``. A CPU
tensor takes the plain version (``sad_windows_plain``); a CUDA tensor
launches the kernel, or raises on a wrong dtype, layout, or a failed build
or launch. ``launches`` counts kernel launches.

On the H100 the kernel's least time (~0.16 us at KITTI size: 0.55 MB of
window bytes) is far below what a launch costs: the device time of a launch
itself, and a round of L2 latency for the centers and one for the windows.
So the kernel starts every window load of a block before using any (aligned
4-byte words on the flat byte address, since ``canvas_r`` is usually
``canvas[1]`` of one (2, R, C) tensor, a view at an odd byte offset; words
reaching outside a canvas are read byte by byte), keeps every thread busy
(one a window row, then one a slide) and computes each term exactly as
packed 16-bit halves. The source's header gives the range argument.
"""

from __future__ import annotations

from ctypes import c_int, c_void_p

import torch

from .. import _kernels

_W = 5          # SAD half-window
_L = 5          # slide half-range
_WIN = 2 * _W + 1

launches = 0
_launch = _kernels.Launcher(
    "sad_windows", "sad_windows_launch",
    [c_void_p, c_void_p, c_int, c_int, c_void_p, c_void_p, c_void_p,
     c_int, c_void_p, c_void_p])


def sad_windows_plain(canvas_l: torch.Tensor, canvas_r: torch.Tensor,
                      yc: torch.Tensor, xl: torch.Tensor, xr: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 3 (the reference's dynamic-slice branch,
    iv_slam_tpu/ops/stereo.py:123-145): (N, 11) float32 SAD of the 11x11
    left patch at (yc, xl) against each 11x11 window of the 11x21 right
    strip at (yc, xr), both centred on their own middle pixel. Integer
    values, exact in float32 in any summation order."""
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


def sad_windows(canvas_l: torch.Tensor, canvas_r: torch.Tensor,
                yc: torch.Tensor, xl: torch.Tensor, xr: torch.Tensor) -> torch.Tensor:
    """(N, 11) float32 SAD distances of the 11x11 left patch at (yc, xl)
    slid over the 11x21 right strip at (yc, xr); centers pre-clipped by the
    caller. Bit-equal to ``sad_windows_plain``. The canvases may be views at
    any byte offset; N = 0 returns an empty (0, 11) tensor and launches
    nothing."""
    global launches
    if canvas_l.device.type == "cpu":
        return sad_windows_plain(canvas_l, canvas_r, yc, xl, xr)
    if canvas_l.device.type != "cuda":
        raise ValueError(f"sad_windows: unsupported device {canvas_l.device}")
    for name, t, dt, nd in (("canvas_l", canvas_l, torch.uint8, 2),
                            ("canvas_r", canvas_r, torch.uint8, 2),
                            ("yc", yc, torch.int32, 1), ("xl", xl, torch.int32, 1),
                            ("xr", xr, torch.int32, 1)):
        if (t.dtype != dt or t.ndim != nd or not t.is_contiguous()
                or t.device != canvas_l.device):
            raise ValueError(
                f"sad_windows: {name} must be a contiguous {nd}-d {dt} tensor on "
                f"{canvas_l.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    n = yc.shape[0]
    if canvas_r.shape != canvas_l.shape or xl.shape[0] != n or xr.shape[0] != n:
        raise ValueError("sad_windows: canvases or center lengths disagree")
    out = torch.empty((n, 11), dtype=torch.float32, device=canvas_l.device)
    if n == 0:
        return out
    with torch.cuda.device(canvas_l.device):
        _launch(canvas_l.data_ptr(), canvas_r.data_ptr(), canvas_l.shape[0],
                canvas_l.shape[1], yc.data_ptr(), xl.data_ptr(), xr.data_ptr(),
                n, out.data_ptr(), _kernels.stream_of(canvas_l))
    launches += 1
    return out
