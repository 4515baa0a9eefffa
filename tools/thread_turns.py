#!/usr/bin/env python3
"""The thread architecture's three configurations in turns on one GPU:
``chip_smoke.py`` phase 14 (a)'s runs (the first 60 frames of the full
loop through System: inline, the LocalMapping worker with the async local
BA, the async local BA alone), each run twice in the order A B C C B A in
one process, so that a difference between configurations can be read
against the spread of one configuration inside the call.

    python3 tools/thread_turns.py

Run from the root of a checkout, on a machine with a CUDA card. Each run
prints one JSON line (frames/s over frames 15-60 and over all, ATE,
keyframes, events on the worker, the median event's host ms, the card's
busy share from NVML, the largest pending count, the async BA's merges at
the per-frame poll and at a forced join, lost frames); the last line holds
every run and the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import sys
from types import SimpleNamespace

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIGS = {"inline": (False, False), "worker_async_ba": (True, True),
           "async_ba": (False, True)}
ORDER = ("inline", "worker_async_ba", "async_ba", "async_ba", "worker_async_ba", "inline")
KEEP = ("fps", "fps_all", "ate_m", "keyframes", "worker_events", "event_host_ms_median",
        "device_busy_share", "max_pending", "ba_merges_at_poll", "ba_merges_at_join",
        "lost_frames")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("thread_turns: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from iv_slam_tpu_torch import _kernels, config
    from iv_slam_tpu_torch.io import trajectory
    from iv_slam_tpu_torch.ops import brief, fast, fast_cuda, finish_cuda, orient, stereo_cuda
    from iv_slam_tpu_torch.slam import frame, fused_track, system
    from iv_slam_tpu_torch.utils import profiling

    ops = SimpleNamespace(brief=brief, fast=fast, fast_cuda=fast_cuda, finish_cuda=finish_cuda,
                          orient=orient, stereo_cuda=stereo_cuda)
    port = {"kernels": _kernels, "config": config, "frame": frame, "ops": ops,
            "fused": fused_track, "trajectory": trajectory, "system": system,
            "profiling": profiling}
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    smoke = cs.Smoke(torch, port)
    smoke.build()
    smoke.tracking_setup()
    t = smoke.trk
    t.loop_gt = cs.loop_path(cs.N_THR)
    t.loop_pairs = [t.world.render_stereo(T) for T in t.loop_gt]
    rows = []
    for name in ORDER:
        run = smoke._thr_run(cs.N_THR, *CONFIGS[name])[0]
        rows.append(dict(name=name, **{k: run[k] for k in KEEP}))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"turns": rows, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
