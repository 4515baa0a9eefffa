#!/usr/bin/env python3
"""The readings the checks' limits are set from, on the card at the cells'
own sizes. Not part of a benchmark run.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3

prints one JSON line a seed with, for each number a cell compares:
``program`` (the system under test against the plain reference, as a run
reads it), ``control`` (the reference in the nearest precision below the
configuration's: TF32 for float32 without TF32, against the float32
reference) and, for training, ``half_batch`` (the reference stepping on
half of each batch, the mean taken over it: a fault the checks must
catch). A state left unchanged reads 1 on ``change_median_gap`` by
definition. Training also gives how far round-off alone carries three
steps: ``ulp`` (the reference against itself, every weight
one ulp up), ``float64`` (the float32 reference against the float64 one)
and ``program_vs_float64``.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def costmap(cfg, wl, seed, dev):
    import torch
    from iv_slam_tpu_torch import models

    from portbench.drivers import common
    from portbench.drivers.costmap import check_indices, reference_map, stream_setup

    cam = cfg["camera"]
    hw = (cam["height"], cam["width"])
    net, w, ring = stream_setup(cfg, wl, seed, 0, dev)
    prog, ctrl = common.MapGap(), common.MapGap()
    for j in check_indices(seed, 0, wl, len(ring), len(ring)):
        want = reference_map(cfg, w, ring[j])
        prog.add(models.inference_cost_map(net, ring[j], hw, tuple(cfg["net_hw"])), want)
        ctrl.add(reference_map(cfg, w, ring[j], "tf32"), want)
    return {k: dict(cost_max_diff=g.worst, cost_diff_share=g.share)
            for k, g in (("program", prog), ("control", ctrl))}


def track(cfg, wl, seed, dev):
    """Session 0's world and checked frames, cost maps only (the frontend
    comparison is exact; ATE has no reference to lower)."""
    import numpy as np
    import torch
    from iv_slam_tpu_torch import models

    from portbench.drivers import common
    from portbench.drivers.track import reference_map, world_of
    from portbench.traffic import circuit, seeds, world

    cam = cfg["camera"]
    hw = (cam["height"], cam["width"])
    wd, c = wl["world"], wl["circuit"]
    scene = world.PlaneWorld(seeds.rng(wd["seed"], 300, world_of(seed, 0, wl["sessions"])),
                             tex_size=wd["tex_size"], res=wd["res"],
                             fx=cam["fx"], fy=cam["fy"], cx=cam["cx"], cy=cam["cy"],
                             w=cam["width"], h=cam["height"], baseline=cam["bf"] / cam["fx"])
    lap = circuit.lap(c["frames"], c["v_min"], c["v_max"], c["aspect"], c["height"],
                      c["yaw_amp"], c["yaw_waves"])
    frames = [int(f) for f in wl["check_from"] + common.sample(
        seed, 400, wl["check_span"], 4)]
    greys = [scene.render(lap[0])] + [scene.render(lap[f % len(lap)]) for f in frames]
    calib = torch.from_numpy(greys[0]).to(dev)[None, ..., None].expand(-1, -1, -1, 3)
    net, w = common.seeded_fcn(cfg, seed, dev, calib_rgb=calib)
    prog, ctrl = common.MapGap(), common.MapGap()
    for g in greys[1:]:
        want = reference_map(cfg, w, g, dev)
        img = torch.from_numpy(np.ascontiguousarray(g)).to(dev)[..., None].expand(-1, -1, 3)
        prog.add(models.inference_cost_map(net, img, hw, tuple(cfg["net_hw"])), want)
        ctrl.add(reference_map(cfg, w, g, dev, "tf32"), want)
    out = {k: dict(cost_max_diff=g.worst, cost_diff_share=g.share)
           for k, g in (("program", prog), ("control", ctrl))}
    # a tracker whose pose never leaves the first frame's, over a window's frames
    from portbench.reference.trajectory import ate_rmse

    n = wl["warmup_frames"] + 60
    gt = np.stack([lap[i % len(lap)] for i in range(n)])
    out["frozen_pose"] = dict(ate_max_m=ate_rmse(np.repeat(gt[:1], n, 0), gt))
    return out


def train(cfg, wl, seed, dev):
    import torch

    from portbench.drivers import train as tr
    from portbench.reference import fcn as ref

    trainer, host, _, w, first = tr.setup(cfg, wl, seed, dev)
    del trainer
    torch.cuda.empty_cache()
    feed = tr.reference_feed(cfg, host, first["rows"], dev)
    r32 = ref.train_steps(cfg["fcn"], cfg["recipe"], w, feed)
    out = dict(program=tr.compare(first, r32, w))
    out["control"] = tr.compare(ref.train_steps(cfg["fcn"], cfg["recipe"], w, feed, "tf32"),
                                r32, w)
    half = slice(0, cfg["batch_size"] // 2)
    out["half_batch"] = tr.compare(
        ref.train_steps(cfg["fcn"], cfg["recipe"], w, feed, rows=half), r32, w)
    up = {k: v if ref.is_buffer(k) else torch.nextafter(v, torch.full_like(v, float("inf")))
          for k, v in w.items()}
    out["ulp"] = tr.compare(ref.train_steps(cfg["fcn"], cfg["recipe"], up, feed), r32, w)
    r64 = ref.train_steps(cfg["fcn"], cfg["recipe"], {k: v.double() for k, v in w.items()},
                          [tuple(t.double() for t in b) for b in feed])
    out["float64"] = tr.compare(r32, r64, w)
    out["program_vs_float64"] = tr.compare(first, r64, w)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--root", default=ROOT, help="the checkout (default: this file's)")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)
    if ROOT not in sys.path:
        sys.path.append(ROOT)
    import torch

    from portbench.lib import spec

    sp = spec.cell_spec(args.workload, args.root, os.path.join(args.root, "portbench"))
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    fn = {"costmap": costmap, "track": track, "train": train}[sp["workload"]["driver"]]
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.time()
        res = fn(sp["config"], sp["workload"], seed, dev)
        print(json.dumps(dict(workload=args.workload, seed=seed, seconds=time.time() - t,
                              device=str(dev), **res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
