"""Wrapper of kernel 1, ``csrc/fast_score.cu``: FAST-9/16 score maps.

Replaces ``iv_slam_tpu/ops/fast_pallas.py::fast_score_pallas``. A CPU
tensor takes the plain version (``ops/fast.py::fast_score``); a CUDA tensor
launches the kernel, or raises on a wrong dtype, layout, or a failed build
or launch. ``launches`` counts kernel launches: one for all the levels of a
call.
"""

from __future__ import annotations

from ctypes import POINTER, c_int, c_void_p
from typing import List

import torch

from .. import _kernels
from . import fast

MAX_LEVELS = 32  # csrc/fast_score.cu MAX_LEVELS

launches = 0
_ARGS = [POINTER(c_void_p), POINTER(c_void_p), POINTER(c_int), POINTER(c_int),
         c_int, c_int, c_int, c_void_p]
_launch = _kernels.Launcher("fast_score", "fast_score_levels_launch", _ARGS)


def fast_score_levels(levels: List[torch.Tensor], threshold: int) -> List[torch.Tensor]:
    """FAST score maps (no NMS) of pyramid levels, each (B, h_l, w_l) uint8
    with one B, as contiguous int16 views of one allocation; bit-equal to
    ``fast.fast_score`` per level. On the card, one launch for all levels."""
    global launches
    if not levels:
        return []
    dev = levels[0].device
    if dev.type == "cpu":
        return [fast.fast_score(lv, threshold) for lv in levels]
    if dev.type != "cuda":
        raise ValueError(f"fast_score_levels: unsupported device {dev}")
    if len(levels) > MAX_LEVELS:
        raise ValueError(f"fast_score_levels: {len(levels)} levels, at most {MAX_LEVELS}")
    b = levels[0].shape[0] if levels[0].ndim == 3 else -1
    for lv in levels:
        if (lv.dtype != torch.uint8 or lv.ndim != 3 or lv.shape[0] != b
                or not lv.is_contiguous() or lv.device != dev):
            raise ValueError(
                f"fast_score_levels: need contiguous (B, h, w) uint8 tensors with one B "
                f"on {dev}, got {tuple(lv.shape)} {lv.dtype} on {lv.device} "
                f"contiguous={lv.is_contiguous()}")
    sizes = [lv.numel() for lv in levels]
    flat = torch.empty(sum(sizes), dtype=torch.int16, device=dev)
    outs = [o.view(lv.shape) for o, lv in zip(torch.split(flat, sizes), levels)]
    n = len(levels)
    with torch.cuda.device(dev):
        _launch((c_void_p * n)(*[lv.data_ptr() for lv in levels]),
                (c_void_p * n)(*[o.data_ptr() for o in outs]),
                (c_int * n)(*[lv.shape[1] for lv in levels]),
                (c_int * n)(*[lv.shape[2] for lv in levels]),
                n, b, int(threshold), _kernels.stream_of(levels[0]))
    launches += sum(sizes) > 0  # the entry point launches nothing for no pixels
    return outs


def fast_score(img: torch.Tensor, threshold: int) -> torch.Tensor:
    """(H, W) or (B, H, W) uint8 -> same-shape int16 FAST score map (no
    NMS), bit-equal to ``fast.fast_score``: ``fast_score_levels`` of one
    level."""
    if img.device.type == "cpu":
        return fast.fast_score(img, threshold)
    if img.ndim not in (2, 3):
        raise ValueError(f"fast_score: need an (H, W) or (B, H, W) tensor, "
                         f"got {tuple(img.shape)}")
    lv = img if img.ndim == 3 else img.unsqueeze(0)
    return fast_score_levels([lv], threshold)[0].view(img.shape)
