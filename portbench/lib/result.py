"""The run's last line: correct, attempted, failed, the metrics, the device,
the trace's breakdown, and last the numbers compared with their limits."""

from __future__ import annotations

import math
from typing import List

import numpy as np

from . import spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "iv_slam_tpu")


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``iv_slam_tpu_torch`` is not ``iv_slam_tpu``)."""
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})


def checks_ok(checks) -> bool:
    return all(math.isfinite(v) and v <= lim for _, v, lim in checks)


def device_data(out: dict) -> dict:
    """Busy and window seconds, the breakdown, and per-kernel device seconds
    from the processes' device summaries. A summary names its card
    (``chip``, 0 by default); busy seconds are each card's union of
    intervals, averaged over the ``chips`` the run used (1 by default)."""
    t0, t1 = out["t0_ns"], out["t1_ns"]
    procs = out["device"]
    starts = np.concatenate([p["starts"] for p in procs])
    ends = np.concatenate([p["ends"] for p in procs])
    busy = 0.0
    for c in {p.get("chip", 0) for p in procs}:
        mine = [p for p in procs if p.get("chip", 0) == c]
        busy += trace.union(np.concatenate([p["starts"] for p in mine]),
                            np.concatenate([p["ends"] for p in mine]))[0]
    gaps = trace.union(starts, ends)[1]
    ops = {}
    for p in procs:
        for k, v in p["ops"].items():
            ops[k] = ops.get(k, 0.0) + v
    first = int(starts.min()) if len(starts) else None
    last = int(ends.max()) if len(ends) else None
    idle = trace.idle_by_host(gaps, out["spans"], t0, t1, first, last)
    return dict(busy_s=busy / out.get("chips", 1), window_s=(t1 - t0) * 1e-9, ops=ops,
                breakdown=dict(
                    device_ops=[[k, v] for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:10]],
                    idle_gaps=[[k, v] for k, v in idle]))


def build(sp: dict, out: dict, traced: bool, setup_s: float, device: dict) -> dict:
    """The result object; per-layer readers are found by their metric's name."""
    line = dict(correct=checks_ok(out["checks"]), attempted=int(out["attempted"]),
                failed=int(out["failed"]), metrics={}, device=dict(device))
    line["device"]["memory_peak_bytes"] = int(out["memory_peak_bytes"])
    if not traced:
        values = dict(out["e2e"], setup_s=setup_s)
        for m in sp["end_to_end"]:
            line["metrics"][m["name"]] = dict(value=float(values[m["name"]]), unit=m["unit"])
    else:
        dev = device_data(out)
        data = dict(out["data"], busy_s=dev["busy_s"], window_s=dev["window_s"],
                    device_ops=dev["ops"])
        for m in sp["per_layer"]:
            v = spec.load_module("metrics", m["name"], sp["here"]).read(data)
            if v is not None:
                line["metrics"][m["name"]] = dict(value=float(v), unit=m["unit"])
        line["device"]["busy_s"] = dev["busy_s"]
        line["device"]["window_s"] = dev["window_s"]
        line["breakdown"] = dev["breakdown"]
    line["checks"] = {n: dict(value=float(v), limit=float(lim)) for n, v, lim in out["checks"]}
    return line
