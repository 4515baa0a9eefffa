"""The program's spans on a traced run's device trace: per span, the kernels
it launched, the host syncs it made and the kernels' device time.

The program records its spans with ``iv_slam_tpu_torch.utils.profiling``:
plain tuples (name, start_ns, end_ns, serial, parent serial, thread, id
kind, id) on ``time.time_ns``, the clock of the profiler's events.
``RuntimeTrace`` is the benchmark's ``DeviceTrace`` (the same profiler, CUDA
activity only) that also keeps each device event's correlation id and the
CUDA runtime's records of the same trace: every runtime call with its host
start and correlation id, marked when it is a host sync. ``credit`` gives
each record to the innermost program span of the process whose interval
holds its host time: a kernel through its launch record's correlation id,
a sync directly. Time alone decides the span: autograd's device thread
launches the backward while the main thread sits in the span around it.

``track_body`` and ``costmap_body`` wrap the drivers' client bodies so
that a client hands back its program spans with their credits
(portbench/trace_program.py)."""

from __future__ import annotations

import heapq
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from .trace import DeviceTrace

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")

# the fields of a credited span row (``credit``)
ROW_FIELDS = ("name", "start_ns", "end_ns", "serial", "parent", "id_kind", "id",
              "launches", "syncs", "device_ns")


class RuntimeTrace(DeviceTrace):
    """``DeviceTrace`` with correlation ids and the runtime's records."""

    def stop(self):
        from torch.autograd import DeviceType

        want = DeviceType.CUDA if self.cuda else DeviceType.CPU
        self.prof.stop()
        names, starts, ends, corr = [], [], [], []
        rt_ns, rt_corr, rt_sync = [], [], []
        for e in self.prof.profiler.kineto_results.events():
            kind = e.device_type()
            if kind == want:
                names.append(e.name())
                starts.append(e.start_ns())
                ends.append(e.end_ns())
                corr.append(e.correlation_id())
            elif self.cuda and kind == DeviceType.CPU and e.correlation_id():
                rt_ns.append(e.start_ns())
                rt_corr.append(e.correlation_id())
                rt_sync.append(e.name() in SYNCS)
        self.prof = None
        self.names = names
        self.start_ns = np.asarray(starts, np.int64)
        self.end_ns = np.asarray(ends, np.int64)
        self.corr = np.asarray(corr, np.int64)
        self.kernel = np.asarray([not n.startswith(("Memcpy", "Memset")) for n in names], bool)
        self.runtime = dict(ns=np.asarray(rt_ns, np.int64), corr=np.asarray(rt_corr, np.int64),
                            sync=np.asarray(rt_sync, bool))

    def summary(self, t0_ns: int, t1_ns: int) -> dict:
        """``DeviceTrace.summary`` and, under ``records``, what ``credit``
        reads (taken off by the session wrappers before the result leaves
        the client)."""
        out = super().summary(t0_ns, t1_ns)
        out["records"] = dict(start_ns=self.start_ns, end_ns=self.end_ns, corr=self.corr,
                              kernel=self.kernel, runtime=self.runtime)
        return out


def innermost(spans: List[tuple], t: np.ndarray) -> np.ndarray:
    """Index into `spans` ((name, start_ns, end_ns, ...)) of the innermost
    span (the latest start) whose interval holds each time of `t`; -1
    where none does."""
    if not spans or len(t) == 0:
        return np.full(len(t), -1, np.int64)
    bounds = sorted({s[1] for s in spans} | {s[2] + 1 for s in spans})
    starts = defaultdict(list)
    for i, s in enumerate(spans):
        starts[s[1]].append(i)
    label = np.full(len(bounds), -1, np.int64)
    heap: list = []   # (-start, end, i): the open span that began last on top
    for j, b in enumerate(bounds):
        for i in starts.get(b, ()):
            heapq.heappush(heap, (-spans[i][1], spans[i][2], i))
        while heap and heap[0][1] < b:   # ended: closed for every later bound too
            heapq.heappop(heap)
        if heap:
            label[j] = heap[0][2]
    seg = np.searchsorted(np.asarray(bounds, np.int64), t, side="right") - 1
    return np.where(seg >= 0, label[np.clip(seg, 0, None)], -1)


def credit(spans: List[tuple], records: dict) -> List[tuple]:
    """The program's spans (profiling tuples) with what the trace credits
    to each: rows of ``ROW_FIELDS``. ``records``: ``RuntimeTrace``'s."""
    rt = records["runtime"]
    n = len(spans)
    launches = np.zeros(n, np.int64)
    syncs = np.zeros(n, np.int64)
    device_ns = np.zeros(n, np.int64)
    if n and len(rt["ns"]):
        order = np.argsort(rt["corr"], kind="stable")
        rc, rns = rt["corr"][order], rt["ns"][order]
        k = records["kernel"] & (records["corr"] > 0)
        kc = records["corr"][k]
        pos = np.clip(np.searchsorted(rc, kc), 0, len(rc) - 1)
        found = rc[pos] == kc
        who = innermost(spans, rns[pos][found])
        dur = (records["end_ns"][k] - records["start_ns"][k])[found]
        hit = who >= 0
        launches += np.bincount(who[hit], minlength=n)
        device_ns += np.bincount(who[hit], weights=dur[hit], minlength=n).astype(np.int64)
        sw = innermost(spans, rt["ns"][rt["sync"]])
        syncs += np.bincount(sw[sw >= 0], minlength=n)
    return [(s[0], s[1], s[2], s[3], s[4], s[6], s[7], int(a), int(b), int(c))
            for s, a, b, c in zip(spans, launches, syncs, device_ns)]


def subtree_totals(rows: List[tuple]) -> Dict[int, tuple]:
    """Serial -> (launches, syncs, device_ns) of the span and every span
    opened inside it (one process's rows)."""
    tot = {r[3]: [r[7], r[8], r[9]] for r in rows}
    for r in sorted(rows, key=lambda r: -r[3]):   # a child's serial is above its parent's
        p = tot.get(r[4])
        if p is not None:
            t = tot[r[3]]
            p[0] += t[0]
            p[1] += t[1]
            p[2] += t[2]
    return {k: tuple(v) for k, v in tot.items()}


def in_window(rows: List[tuple], t0: int, t1: int) -> List[tuple]:
    return [r for r in rows if t0 <= r[1] and r[2] <= t1]


def median(values) -> Optional[float]:
    return float(np.median(values)) if len(values) else None


def host_ms(procs: List[List[tuple]], name: str, t0: int, t1: int) -> Optional[float]:
    """Median host ms of the spans `name` inside the window."""
    return median([(r[2] - r[1]) * 1e-6 for rows in procs for r in in_window(rows, t0, t1)
                   if r[0] == name])


def per_span(procs: List[List[tuple]], name: str, field: int, t0: int, t1: int,
             scale: float = 1.0) -> Optional[float]:
    """Median over the spans `name` inside the window of their subtree's
    total `field` (0 launches, 1 syncs, 2 device ns) times `scale`."""
    vals = []
    for rows in procs:
        tot = subtree_totals(rows)
        vals += [tot[r[3]][field] * scale for r in in_window(rows, t0, t1) if r[0] == name]
    return median(vals)


def span_table(procs: List[List[tuple]], t0: int, t1: int) -> Dict[str, list]:
    """Per span name inside the window: [count, median host ms, and the
    medians of its subtree's launches, syncs and device ms]."""
    by: Dict[str, list] = defaultdict(list)
    for rows in procs:
        tot = subtree_totals(rows)
        for r in in_window(rows, t0, t1):
            la, sy, dn = tot[r[3]]
            by[r[0]].append(((r[2] - r[1]) * 1e-6, la, sy, dn * 1e-6))
    return {n: [len(v)] + [float(x) for x in np.median(np.asarray(v), axis=0)]
            for n, v in sorted(by.items())}


# the eight per-span readings: cell prefix -> metric -> (kind, span, field, scale)
METRICS = {
    "track": {
        "fused_dispatch_ms.track": ("host", "fused_dispatch"),
        "track_launches.track": ("count", "system.track", 0, 1.0),
        "track_device_ms.track": ("count", "system.track", 2, 1e-6),
        "frontend_launches.track": ("count", "system.submit", 0, 1.0),
        "keyframe_event_syncs.track": ("count", "keyframe_event", 1, 1.0),
    },
    "train": {"upload_ms.train": ("host", "train.upload")},
    "costmap": {
        "fcn_launches.costmap": ("count", "fcn.cost_map", 0, 1.0),
        "fcn_device_ms.costmap": ("count", "fcn.cost_map", 2, 1e-6),
    },
}


def readings(cell: str, procs: List[List[tuple]], t0: int, t1: int,
             has_runtime: bool) -> Dict[str, Optional[float]]:
    """The cell's per-span readings; a count is None without runtime
    records (the CPU rehearsals), a reading None without its spans."""
    out = {}
    for metric, spec in METRICS.get(cell.split(".", 1)[0], {}).items():
        if spec[0] == "host":
            out[metric] = host_ms(procs, spec[1], t0, t1)
        else:
            out[metric] = per_span(procs, spec[1], spec[2], t0, t1, spec[3]) \
                if has_runtime else None
    return out


def program_rows(summary: Optional[dict]) -> dict:
    """The installed recorder's spans credited from a device summary
    (``RuntimeTrace.summary``), whose raw records are taken off:
    {rows, has_runtime}."""
    from iv_slam_tpu_torch.utils import profiling

    timer = getattr(profiling, "active", lambda: None)()
    spans = list(getattr(timer, "spans", ()))
    records = summary.pop("records", None) if summary else None
    has_runtime = bool(records is not None and len(records["runtime"]["ns"]))
    rows = credit(spans, records) if records is not None else \
        [(s[0], s[1], s[2], s[3], s[4], s[6], s[7], 0, 0, 0) for s in spans]
    return dict(rows=rows, has_runtime=has_runtime)


def _patched(body, install: bool):
    """Runs a driver's client body with ``RuntimeTrace`` in place of
    ``DeviceTrace`` and a recorder installed: a new one first, or where the
    driver makes its own (the tracking driver sets it as ``stage_timer`` on
    Tracking and LocalMapping, which records their stages only), that one as
    it is made, so the System's, frontend's and fused step's spans join it.
    The body runs in a spawned client process, which the patch ends with."""
    from iv_slam_tpu_torch.utils import profiling

    from . import trace

    def run(*args):
        trace.DeviceTrace = RuntimeTrace
        if install:
            profiling.install(profiling.StageTimer())
        else:
            made = profiling.StageTimer.__init__

            def init(timer):
                made(timer)
                profiling.install(timer)
            profiling.StageTimer.__init__ = init
        out = body(*args)
        out["program"] = program_rows(out.get("device"))
        return out
    return run


def track_body(*args):
    from ..drivers import track

    return _patched(track._session_body, install=False)(*args)


def costmap_body(*args):
    from ..drivers import costmap

    return _patched(costmap._stream_body, install=True)(*args)
