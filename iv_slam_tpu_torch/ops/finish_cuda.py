"""Wrapper of kernel 2, ``csrc/orient_brief.cu``: IC angles + rBRIEF.

Replaces ``iv_slam_tpu/ops/finish_pallas.py::orient_brief_pallas`` (the
``_finish_kernel`` patch gather plus the descriptor lookup after it) on
the flattened pyramid canvases. A CPU tensor takes the plain version
(``orient.ic_angles_integral`` then ``brief.descriptors_global_gather``);
a CUDA tensor launches the fused kernel, or raises on a wrong dtype,
layout, or a failed build or launch. ``launches`` counts kernel launches.
"""

from __future__ import annotations

from ctypes import c_int, c_void_p
from typing import Dict, Tuple

import numpy as np
import torch

from .. import _kernels
from . import brief, orient

launches = 0
_launch = _kernels.Launcher(
    "orient_brief", "orient_brief_launch",
    [c_void_p, c_void_p, c_int, c_int, c_void_p, c_int, c_void_p,
     c_void_p, c_void_p, c_void_p, c_void_p])
_tables: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def orient_brief_plain(raw: torch.Tensor, blur: torch.Tensor, yx: torch.Tensor):
    """The plain PyTorch version: (angles (N,) f32, desc (N, 32) uint8)."""
    ang = orient.ic_angles_integral(raw, yx)
    return ang, brief.descriptors_global_gather(blur, yx, ang)


# the kernel stages a (2 REACH + 1)^2 window of the blurred canvas around
# each keypoint (csrc/orient_brief.cu REACH)
REACH = 18


def pattern_reach(pat: np.ndarray) -> int:
    """The largest |rint(x sin + y cos)| or |rint(x cos - y sin)| of the
    pattern points (x, y) over all angles: rint of the largest point norm
    (|x sin + y cos| <= hypot(x, y)), refused within 1e-3 of a .5 boundary
    where f32 rounding could tip it."""
    r = float(np.hypot(pat[:, 0], pat[:, 1]).max())
    if abs(r - np.floor(r) - 0.5) < 1e-3:
        raise ValueError(f"pattern norm {r} too close to a rounding boundary")
    return int(np.floor(r + 0.5))


def _device_tables(dev: torch.device):
    """BRIEF pattern (512, 2) int8, one 4-byte word per point pair, and the
    circular patch extents (31,) int32, cached on the device so the
    per-frame path uploads nothing. Checks what the kernel relies on: the
    rotated pattern stays within REACH px, and the patch mask is symmetric,
    so the extent of row v is also that of column v."""
    t = _tables.get(dev)
    if t is None:
        pat = brief.pattern()
        if pattern_reach(pat) > REACH or np.abs(pat).max() > 127:
            raise ValueError(f"BRIEF pattern reaches {pattern_reach(pat)} px; "
                             f"the kernel's window holds {REACH}")
        ext = orient.row_extents()
        u = np.arange(-orient.HALF_PATCH, orient.HALF_PATCH + 1)
        mask = np.abs(u)[None, :] <= ext[:, None]
        if not np.array_equal(mask, mask.T):  # the kernel sums columns
            raise ValueError("circular patch mask is not symmetric")
        t = (torch.as_tensor(pat.astype(np.int8), device=dev).contiguous(),
             torch.as_tensor(ext, dtype=torch.int32, device=dev))
        _tables[dev] = t
    return t


def orient_brief(raw: torch.Tensor, blur: torch.Tensor, yx: torch.Tensor):
    """Angles and descriptors of keypoints on a pyramid canvas.

    raw/blur: (R, W) uint8 canvases (unblurred / 7x7 sigma=2 blurred);
    yx: (N, 2) int32 canvas coords (the extractor keeps them 19 px from
    every level border; any position gives the plain result). Returns
    (angles_deg (N,) float32, desc (N, 32) uint8), bit-equal to
    ``orient_brief_plain``.
    """
    global launches
    if raw.device.type == "cpu":
        return orient_brief_plain(raw, blur, yx)
    if raw.device.type != "cuda":
        raise ValueError(f"orient_brief: unsupported device {raw.device}")
    for name, t, dt, nd in (("raw", raw, torch.uint8, 2), ("blur", blur, torch.uint8, 2),
                            ("yx", yx, torch.int32, 2)):
        if t.dtype != dt or t.ndim != nd or not t.is_contiguous() or t.device != raw.device:
            raise ValueError(
                f"orient_brief: {name} must be a contiguous {nd}-d {dt} tensor on "
                f"{raw.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if blur.shape != raw.shape or yx.shape[1] != 2:
        raise ValueError(f"orient_brief: shapes {tuple(raw.shape)} "
                         f"{tuple(blur.shape)} {tuple(yx.shape)}")
    pat, ext = _device_tables(raw.device)
    n = yx.shape[0]
    ang = torch.empty(n, dtype=torch.float32, device=raw.device)
    desc = torch.empty((n, 32), dtype=torch.uint8, device=raw.device)
    with torch.cuda.device(raw.device):
        _launch(raw.data_ptr(), blur.data_ptr(), raw.shape[0], raw.shape[1],
                yx.data_ptr(), n, pat.data_ptr(), ext.data_ptr(),
                ang.data_ptr(), desc.data_ptr(), _kernels.stream_of(raw))
    launches += n > 0  # the entry point launches nothing for no keypoints
    return ang, desc
