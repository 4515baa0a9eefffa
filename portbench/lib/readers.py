"""Arithmetic the per-layer readers share."""

from __future__ import annotations

import numpy as np

from ..counts.peaks import PEAK_FP32_FLOPS


def ms(values, q: float):
    """The q-th percentile of seconds, in ms; None for no values."""
    return float(np.percentile(np.asarray(values) * 1e3, q)) if len(values) else None


def idle_pct(data: dict):
    """The window's share with no kernel, copy or set on the card."""
    if data["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - data["busy_s"] / data["window_s"])


def mfu_pct(flops: float, data: dict):
    """FLOPs done over the window against the card's float32 peak."""
    if data["window_s"] <= 0 or flops <= 0:
        return None
    return 100.0 * flops / data["window_s"] / PEAK_FP32_FLOPS


def roofline_pct(data: dict, kernels: dict):
    """Kernels' share of their roofline over the traced window: each
    kernel's launches times its least time a launch (counts/kernels.py at
    the card's peaks, averaged over the checked frames, whose keypoints set
    K2's and K3's bytes), summed, over the kernels' summed profiler device
    time. ``kernels`` maps a kernel's name in counts/kernels.py to a part
    of its symbol. None where the trace or the checked frames have none."""
    from ..counts.peaks import bound_s

    if not data["kernel_counts"]:
        return None
    bound, time_s = 0.0, 0.0
    for kernel, symbol in kernels.items():
        names = [n for n in data["device_ops"] if symbol in n]
        time_s += sum(data["device_ops"][n] for n in names)
        per_launch = float(np.mean([bound_s(*c[kernel]) for c in data["kernel_counts"]]))
        bound += per_launch * sum(data["kernel_launches"].get(n, 0) for n in names)
    return 100.0 * bound / time_s if time_s > 0 else None
