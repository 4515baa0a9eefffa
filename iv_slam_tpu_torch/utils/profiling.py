"""The port's span recorder (the ``--profile_stages`` report, and the
program's spans on a device trace).

Port of ``StageTimer`` from ``iv_slam_tpu/utils/profiling.py``. The
reference's only instrumentation is wall-clock timing around TrackStereo
with median/mean printouts (stereo_kitti.cc:437-441, 592-599); this adds
named stages with percentiles (``samples``, ``stats``, ``report``, as the
JAX package's) and keeps every span besides.

A span is one plain tuple in ``StageTimer.spans`` (fields ``SPAN_FIELDS``):
its name; its start and end in ``time.time_ns()``, the clock torch.profiler
stamps its events with, so spans and device events line up (``samples``
keep ``time.perf_counter`` durations, as the JAX package's); its serial
number and its parent's (-1 at the top), from a stack kept per thread (the
LocalMapping worker and the async-BA helper record beside the tracking
thread); the thread; and an optional id, ``frame=``, ``kf=`` or ``step=``.

Program code opens a span with ``span(name, ...)``, which records into the
process-wide recorder that ``install`` sets. ``Tracking``, ``LocalMapping``
and ``LoopClosing`` pass their own ``stage_timer`` (None by default): where
one is set, their stages record into it and not into the installed one, so
two Systems in one process can each keep their own. A recorder of another
kind, any object whose ``time(name)`` is a context, is given the name only.
With no recorder a span is a check and a shared no-op context: no clock
read, no allocation. A span reads nothing from the device and never
synchronises.

The JAX package's ``device_trace`` is not ported: it is built on
``jax.profiler``. On the card, ``torch.profiler`` gives device traces.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

# the fields of a span tuple, in order
SPAN_FIELDS = ("name", "start_ns", "end_ns", "serial", "parent", "thread", "id_kind", "id")

_active: Optional["StageTimer"] = None
_OFF = contextlib.nullcontext()


class _Span:
    """One open span of a StageTimer (its context manager)."""

    __slots__ = ("timer", "name", "kind", "ident", "serial", "parent", "t0", "p0")

    def __init__(self, timer, name, kind, ident):
        self.timer, self.name, self.kind, self.ident = timer, name, kind, ident

    def __enter__(self):
        stack = self.timer._stack()
        self.parent = stack[-1] if stack else -1
        self.serial = next(self.timer._serials)
        stack.append(self.serial)
        self.t0 = time.time_ns()
        self.p0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        p1 = time.perf_counter_ns()
        t1 = time.time_ns()
        timer = self.timer
        timer._stack().pop()
        timer.spans.append((self.name, self.t0, t1, self.serial, self.parent,
                            threading.get_ident(), self.kind, self.ident))
        timer.samples[self.name].append((p1 - self.p0) * 1e-9)


class StageTimer:
    """Records spans; ``samples`` holds each name's durations in seconds."""

    def __init__(self):
        self.samples: Dict[str, List[float]] = defaultdict(list)
        self.spans: List[tuple] = []
        self._serials = itertools.count()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def time(self, name: str, frame=None, kf=None, step=None):
        """A context that records one span named `name`, with at most one
        of the ids."""
        if frame is not None:
            return _Span(self, name, "frame", frame)
        if kf is not None:
            return _Span(self, name, "kf", kf)
        if step is not None:
            return _Span(self, name, "step", step)
        return _Span(self, name, None, None)

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


def install(timer: Optional[StageTimer]) -> Optional[StageTimer]:
    """Make `timer` the process-wide recorder (None: record nothing);
    returns the one it replaces."""
    global _active
    prev, _active = _active, timer
    return prev


def active() -> Optional[StageTimer]:
    return _active


def span(name: str, frame=None, kf=None, step=None, timer=None):
    """A context recording the span `name` into `timer`, or where that is
    None into the installed recorder; with neither, the shared no-op
    context. A recorder that is not a StageTimer gets ``time(name)``."""
    if timer is None:
        timer = _active
        if timer is None:
            return _OFF
    if not isinstance(timer, StageTimer):
        return timer.time(name)
    return timer.time(name, frame, kf, step)
