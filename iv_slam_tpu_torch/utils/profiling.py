"""Per-stage wall-clock timers (the ``--profile_stages`` report).

Port of ``StageTimer`` from ``iv_slam_tpu/utils/profiling.py``. The
reference's only instrumentation is wall-clock timing around TrackStereo
with median/mean printouts (stereo_kitti.cc:437-441, 592-599); this adds
named stages with percentiles. Tracking, LocalMapping and LoopClosing time
their stages through ``stage_timer``.

The JAX package's ``device_trace`` is not ported: it is built on
``jax.profiler``. On the card, ``torch.profiler`` gives device traces
(chip_smoke.py profiles the kernels, the tracking step and whole frames
with it).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np


class StageTimer:
    """Accumulates wall-clock samples per named stage."""

    def __init__(self):
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def stats(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            a = np.asarray(xs)
            out[name] = dict(
                n=len(a),
                mean=float(a.mean()),
                median=float(np.median(a)),
                p90=float(np.percentile(a, 90)),
                total=float(a.sum()),
            )
        return out

    def report(self) -> str:
        lines = [f"{'stage':<28}{'n':>6}{'median':>10}{'mean':>10}{'p90':>10}"]
        for name, s in sorted(self.stats().items()):
            lines.append(
                f"{name:<28}{s['n']:>6}{s['median'] * 1e3:>9.2f}m"
                f"{s['mean'] * 1e3:>9.2f}m{s['p90'] * 1e3:>9.2f}m"
            )
        return "\n".join(lines)
