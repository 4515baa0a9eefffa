#!/usr/bin/env python3
"""Run one cell traced, with the program's spans on the device trace.

    python3 portbench/trace_program.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout: run.py's ``--trace 1`` run of the cell with
the drivers' device trace replaced by ``lib/program_trace.RuntimeTrace``
and a span recorder (``iv_slam_tpu_torch.utils.profiling``) installed in
every client (in a tracking session, the driver's own recorder, installed as
it is made). Prints run.py's last
line with, under ``program``: the per-span readings
(``program_trace.METRICS``: launches, host syncs and device ms credited to
a span and the spans inside it, host ms of a span), the idle gaps labelled
by the program's spans beside the benchmark's, each span name's medians in
the window (``span_table``), the program's spans a frame or step, and the
recorder's host cost a span, on and off. Exits 3 without a card, unless
given ``device`` (the CPU rehearsals, where the counts read None).
"""

import time

T_START = time.time()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402


def span_cost_ns(n: int = 100_000) -> dict:
    """Host ns of one span (open and close, with an id), with a recorder
    installed and with none."""
    from iv_slam_tpu_torch.utils import profiling

    out = {}
    prev = profiling.install(None)
    try:
        for key, timer in (("off", None), ("on", profiling.StageTimer())):
            profiling.install(timer)
            t = time.perf_counter_ns()
            for i in range(n):
                with profiling.span("cost", frame=i):
                    pass
            out[key] = (time.perf_counter_ns() - t) / n
    finally:
        profiling.install(prev)
    return out


def run_cell(ctx):
    """(the driver's outcome, each process's credited spans, whether the
    trace had runtime records)."""
    from iv_slam_tpu_torch.utils import profiling

    from portbench.drivers import common
    from portbench.lib import program_trace as pt

    wl, dev, kind = ctx.workload, ctx.device, ctx.workload["driver"]
    args = (ctx.seed, ctx.config, wl, ctx.seconds, True, str(dev))
    if kind == "track":
        from portbench.drivers import track

        if dev.type == "cuda":
            from iv_slam_tpu_torch import _kernels

            _kernels.build(_kernels.SOURCES)
        res = common.run_clients(pt.track_body, wl["sessions"], args, ctx.seconds)
        out = track.aggregate(ctx, res)
    elif kind == "costmap":
        from portbench.drivers import costmap

        res = common.run_clients(pt.costmap_body, wl["streams"], args, ctx.seconds)
        out = costmap.aggregate(ctx, res)
    else:
        from portbench.drivers import train
        from portbench.lib import trace

        prev = profiling.install(profiling.StageTimer())
        kept = trace.DeviceTrace, train.DeviceTrace
        train.DeviceTrace = trace.DeviceTrace = pt.RuntimeTrace
        try:
            out = train.run(ctx)
            res = [dict(program=pt.program_rows(out["device"][0]))]
        finally:
            trace.DeviceTrace, train.DeviceTrace = kept
            profiling.install(prev)
    progs = [r["program"] for r in res]
    return out, [p["rows"] for p in progs], any(p["has_runtime"] for p in progs)


def program_section(cell: str, out: dict, procs, has_runtime: bool) -> dict:
    """What the program's spans add to the traced run's line."""
    from portbench.lib import program_trace as pt
    from portbench.lib import result

    t0, t1 = out["t0_ns"], out["t1_ns"]
    spans = [(r[0], r[1], r[2]) for rows in procs for r in rows]
    dev = result.device_data(dict(out, spans=list(out["spans"]) + spans))
    units = out["attempted"]
    inside = sum(len(pt.in_window(rows, t0, t1)) for rows in procs)
    return dict(metrics=pt.readings(cell, procs, t0, t1, has_runtime),
                idle_gaps=dev["breakdown"]["idle_gaps"],
                spans=pt.span_table(procs, t0, t1),
                spans_per_unit=inside / units if units else None,
                has_runtime=has_runtime, span_ns=span_cost_ns())


def main(argv=None, root=None, device=None) -> int:
    root = root or os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from portbench import run as bench

    args = bench.parse(argv)
    bench._environment(root)
    from portbench.lib import result, spec

    sp = spec.cell_spec(args.workload, root, os.path.join(root, "portbench"))
    import torch

    if device is None:
        if not torch.cuda.is_available():
            print("trace_program: no CUDA device", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
        dev_info = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=1)
    else:
        device = torch.device(device)
        dev_info = dict(platform=device.type, kind=device.type, count=1)
    ctx = SimpleNamespace(name=args.workload, seed=args.seed, seconds=args.seconds,
                          trace=True, device=device, root=root, **sp)
    out, procs, has_runtime = run_cell(ctx)
    line = result.build(sp, out, True, out["t0_ns"] * 1e-9 - T_START, dev_info)
    line["program"] = program_section(args.workload, out, procs, has_runtime)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
