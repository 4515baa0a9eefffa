"""The benchmark's own spans and the device trace of a traced run.

Spans are (name, start_ns, end_ns) on the wall clock (``time.time_ns``),
the clock the profiler's events carry too, so spans and device intervals
of several processes line up. The device trace is ``torch.profiler`` with
CUDA activity only: every kernel, copy and set on the card, with no
per-operator host events.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np


class Spans:
    def __init__(self):
        self.spans: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))


class DeviceTrace:
    """torch.profiler over the measured window; ``stop`` keeps the device
    events as (names, start_ns, end_ns). On a CPU device (the rehearsals)
    the host operators stand in for them."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.prof = None
        self.names: List[str] = []
        self.start_ns = np.zeros(0, np.int64)
        self.end_ns = np.zeros(0, np.int64)

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA if self.cuda
                                        else ProfilerActivity.CPU])
        self.prof.start()

    def stop(self):
        from torch.autograd import DeviceType

        want = DeviceType.CUDA if self.cuda else DeviceType.CPU
        self.prof.stop()
        names, starts, ends = [], [], []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == want:
                names.append(e.name())
                starts.append(e.start_ns())
                ends.append(e.end_ns())
        self.prof = None
        self.names = names
        self.start_ns = np.asarray(starts, np.int64)
        self.end_ns = np.asarray(ends, np.int64)

    def summary(self, t0_ns: int, t1_ns: int) -> dict:
        """The events clipped to the window: per-name device seconds and
        counts, and the clipped intervals for the union over processes."""
        s = np.clip(self.start_ns, t0_ns, t1_ns)
        e = np.clip(self.end_ns, t0_ns, t1_ns)
        keep = e > s
        per_name: Dict[str, float] = defaultdict(float)
        count: Dict[str, int] = defaultdict(int)
        for n, d in zip((n for n, k in zip(self.names, keep) if k), (e - s)[keep]):
            per_name[n] += float(d) * 1e-9
            count[n] += 1
        return dict(ops=dict(per_name), op_counts=dict(count), starts=s[keep], ends=e[keep])


def union(starts: np.ndarray, ends: np.ndarray):
    """(busy seconds, gaps (start_ns, end_ns) arrays) of the union of the
    intervals."""
    if len(starts) == 0:
        return 0.0, (np.zeros(0, np.int64), np.zeros(0, np.int64))
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.concatenate([[True], s[1:] > reach[:-1]])
    g_start = s[new]
    g_end = np.concatenate([reach[np.nonzero(new)[0][1:] - 1], reach[-1:]])
    busy = float(np.sum(g_end - g_start)) * 1e-9
    return busy, (g_end[:-1], g_start[1:])


def idle_by_host(gaps, spans: List[Tuple[str, int, int]], t0_ns: int, t1_ns: int,
                 first_ns: int, last_ns: int) -> List[Tuple[str, float]]:
    """Idle seconds of the window by what the host was doing: each gap (and
    the window's edges before the first and after the last device event) is
    labelled by the shortest-running benchmark span that covers its middle,
    "none" where none does; the ten largest totals."""
    g0 = np.concatenate([[t0_ns], gaps[0], [last_ns]]) if first_ns is not None else \
        np.array([t0_ns])
    g1 = np.concatenate([[first_ns], gaps[1], [t1_ns]]) if first_ns is not None else \
        np.array([t1_ns])
    keep = g1 > g0
    g0, g1 = g0[keep], g1[keep]
    mid = (g0 + g1) // 2
    label = np.full(len(mid), "none", dtype=object)
    by_name = defaultdict(list)
    for n, a, b in spans:
        by_name[n].append((a, b))
    # innermost first: the name whose spans are shortest on average
    order = sorted(by_name, key=lambda n: np.mean([b - a for a, b in by_name[n]]))
    for n in reversed(order):
        iv = np.asarray(sorted(by_name[n]), np.int64)
        _, (ge, gs) = union(iv[:, 0], iv[:, 1])
        s = np.concatenate([iv[:1, 0], gs])
        e = np.concatenate([ge, [iv[:, 1].max()]])
        i = np.searchsorted(s, mid, side="right") - 1
        inside = (i >= 0) & (mid <= e[np.clip(i, 0, None)])
        label[inside] = n
    tot: Dict[str, float] = defaultdict(float)
    for n, d in zip(label, (g1 - g0) * 1e-9):
        tot[n] += float(d)
    return sorted(tot.items(), key=lambda kv: -kv[1])[:10]
