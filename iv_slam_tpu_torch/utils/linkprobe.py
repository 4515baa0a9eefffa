"""Host<->device link characterization (one cached probe per process).

Port of ``iv_slam_tpu/utils/linkprobe.py``. The keyframe event's program
shapes (slam/local_mapping.py ``set_link_profile``: chunk sizes and the
local BA's segmentation) trade device-queue occupancy against host syncs,
and the right trade depends on what a sync costs. ``probe_rtt_ms``
measures it once: the median, over n runs, of a tiny device op followed by
a read of its result on the host. On a locally attached card that is a
kernel launch and a device-to-host copy, a few tens of microseconds, well
under ``SystemConfig.link_rtt_threshold_ms``, so the chunked shapes are
kept; ``set_rtt_ms`` pins the value (tests, a known link).
"""

from __future__ import annotations

import time

import numpy as np
import torch

_RTT_MS = None


def probe_rtt_ms(n: int = 5, force: bool = False, device=None) -> float:
    """Median dispatch -> host-read round trip of a tiny op on `device`
    (the current CUDA device when None, else the CPU), in ms. Cached for
    the process: the link does not change mid-run. A failing probe on the
    card raises; nothing falls back to a guessed value."""
    global _RTT_MS
    if _RTT_MS is not None and not force:
        return _RTT_MS
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    x = torch.ones((8, 8), dtype=torch.float32, device=device)
    (x @ x).cpu()          # the op's first launch loads its kernel
    samples = []
    for _ in range(n):
        t0 = time.perf_counter()
        (x @ x).cpu()
        samples.append(time.perf_counter() - t0)
    _RTT_MS = float(np.median(samples) * 1e3)
    return _RTT_MS


def set_rtt_ms(value) -> None:
    """Pin the probe's result (None forgets it: the next call measures)."""
    global _RTT_MS
    _RTT_MS = None if value is None else float(value)
