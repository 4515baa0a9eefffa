#!/usr/bin/env python3
"""The readings the checks' limits of the zoo and data-parallel training
cells are set from (calibrate.py's, for drivers/train_zoo.py and
drivers/train_dp.py), on the card at the cells' own sizes. Not part of a
benchmark run.

    python3 portbench/calibrate_zoo.py --workload <cell> --seeds 1,2,3

prints one JSON line a seed, each entry the numbers the cell's driver
compares (``train.compare``, ``train_zoo.compare``) against the float32
reference:

``train.r101_ppmds_b8``: ``program`` (as a run reads it), ``control`` (the
reference in TF32), ``mask_off`` (the program against the reference given
the masks with one channel of one sample kept that the program dropped:
``one_channel_off``), ``decoder_rate`` (the reference with the decoder at
the encoder's rate), ``no_deep_sup`` (the reference
with the deep-supervision term left out of the loss, as a program that
drops it), and ``ulp`` (the reference with every weight one ulp up:
round-off alone).

``train.fcn_b8_dp4`` (where BENCHMARK.json names it; PERF.md §7):
``control`` (the reference on the global batch in TF32), and the program's
ranks, one process and one card each over NCCL through the driver's rank
body (on the CPU over gloo): ``program``, and ``local_bn``: the ranks'
BatchNorms without the group, each normalising its own rows.

    python3 portbench/calibrate_zoo.py --workload train.r101_ppmds_b8 --seeds 1 --diverge 14

prints instead the plain reference's loss over 14 steps of the cell's
batches, with seeded channel masks, at the decoder's rate of the
configuration and at the encoder's (upstream's TRAIN.lr_decoder).
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Conn:
    """A rank's end of the driver's pipe when no driver runs it: the window
    starts at once."""

    def send(self, msg):
        pass

    def recv(self):
        return time.time_ns()


def one_channel_off(masks):
    """The checked steps' keep masks with the first channel that the main
    head's dropout dropped in step 1's first sample kept instead."""
    out = [list(ms) for ms in masks]
    m = out[0][0].clone()
    c = int((~m[0].flatten(1).all(1)).nonzero()[0])
    m[0, c] = True
    out[0][0] = m
    return out


def dp_rank(rank, world, port, seed, cfg, wl, device, local_bn, out_path):
    """One rank of the data-parallel driver's body with a window of 0.3 s;
    ``local_bn``: the Trainer gives its BatchNorms no group. Rank 0 writes
    its comparison with the reference to out_path."""
    import torch

    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from iv_slam_tpu_torch.train import trainer as trainer_mod

    from portbench.drivers import train_dp

    torch.set_num_threads(1)
    if local_bn:
        trainer_mod.set_process_group = lambda model, group: None
    wl = dict(wl, ranks=world)
    out = train_dp._rank_body(rank, seed, cfg, wl, 0.3, False, device, port, Conn())
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(dict(out["got"], rank_weight_gap=out["rank_weight_gap"]), f)


def dp_readings(seed, cfg, wl, device, local_bn, world=None) -> dict:
    from iv_slam_tpu_torch.parallel import mesh

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "rank0.json")
        mesh.spawn(dp_rank, world or wl["ranks"], seed, cfg, wl, device, local_bn, path)
        with open(path) as f:
            return json.load(f)


def r101(cfg, wl, seed, dev):
    import torch

    from portbench.drivers import train_zoo as tz
    from portbench.drivers.train import reference_feed
    from portbench.reference import resnet_ppm as ref

    compare = tz.compare

    arch, rc = cfg["fcn"], cfg["recipe"]
    trainer, host, _, w, first = tz.setup(cfg, wl, seed, dev)
    del trainer
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    feed = reference_feed(cfg, host, first["rows"], dev)
    masks = first["masks"]
    r32 = ref.train_steps(arch, rc, w, feed, masks)
    out = dict(program=compare(first, r32, w))
    out["control"] = compare(ref.train_steps(arch, rc, w, feed, masks, "tf32"), r32, w)
    out["mask_off"] = compare(first, ref.train_steps(arch, rc, w, feed, one_channel_off(masks)),
                              w)
    out["decoder_rate"] = compare(first, ref.train_steps(
        arch, dict(rc, lr_decoder=rc["lr"]), w, feed, masks), w)
    out["no_deep_sup"] = compare(ref.train_steps(arch, rc, w, feed, masks, deep_sup=False),
                                 r32, w)
    up = {k: v if ref.is_buffer(k) else torch.nextafter(v, torch.full_like(v, float("inf")))
          for k, v in w.items()}
    out["ulp"] = compare(ref.train_steps(arch, rc, up, feed, masks), r32, w)
    return out


def diverge(cfg, wl, seed, dev, steps):
    """The plain reference's losses over `steps` steps of the cell's batches
    in its seeded order, each dropout's channels drawn from the seed, at
    the configuration's decoder rate and at the encoder's."""
    import numpy as np
    import torch

    from portbench.drivers.train import _order
    from portbench.reference import resnet_ppm as ref
    from portbench.traffic import samples, weights

    arch, rc, B = cfg["fcn"], cfg["recipe"], cfg["batch_size"]
    pool = samples.fcn_pool(seed, wl["pool"], tuple(cfg["input_hw"]), dev, cfg["target_stride"])
    order = _order(seed, wl["pool"] // B)
    rows = [next(order) * B for _ in range(steps)]
    feed = [tuple(pool[k][j:j + B].permute(0, 3, 1, 2) for k in ("image", "target", "mask"))
            for j in rows]
    gen = torch.Generator(device="cpu").manual_seed(seed)
    keep = 1.0 - arch["dropout"]
    widths = (arch["ppm_dim"], arch["fc_dim"] // 4)
    masks = [[(torch.rand(B, c, 1, 1, generator=gen) < keep).to(dev) for c in widths]
             for _ in range(steps)]
    w = weights.fcn_weights(ref.param_shapes(arch), seed, dev)
    out = {}
    for name, lr_dec in (("lr_decoder", rc["lr_decoder"]), ("lr_encoder", rc["lr"])):
        loss = ref.train_steps(arch, dict(rc, lr_decoder=lr_dec), w, feed, masks)["loss"]
        out[name] = dict(rate=lr_dec, loss=loss,
                         first_nonfinite=next((i + 1 for i, v in enumerate(loss)
                                               if not np.isfinite(v)), None))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def dp4(cfg, wl, seed, dev):
    import torch

    from portbench.drivers.train import compare, reference_feed
    from portbench.drivers.train_dp import global_batch
    from portbench.reference import fcn as ref
    from portbench.traffic import samples, weights

    B, hw = global_batch(cfg, wl), tuple(cfg["input_hw"])
    pool = samples.fcn_pool(seed, B, hw, dev, cfg["target_stride"])
    host = {k: v.cpu().numpy() for k, v in pool.items()}
    del pool
    w = weights.fcn_weights(ref.param_shapes(cfg["fcn"]), seed, dev)
    feed = reference_feed(dict(cfg, batch_size=B), host, [0] * 3, dev)
    r32 = ref.train_steps(cfg["fcn"], cfg["recipe"], w, feed)
    out = dict(control=compare(ref.train_steps(cfg["fcn"], cfg["recipe"], w, feed, "tf32"),
                               r32, w))
    out = {k: {n: v for n, v in d.items() if isinstance(v, float)} for k, d in out.items()}
    del r32, feed
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    device = dev.type
    for name, local in (("program", False), ("local_bn", True)):
        out[name] = dp_readings(seed, cfg, wl, device, local)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--root", default=ROOT, help="the checkout (default: this file's)")
    ap.add_argument("--diverge", type=int, default=0,
                    help="r101: the reference's losses over this many steps instead")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)
    if ROOT not in sys.path:
        sys.path.append(ROOT)
    import torch

    from portbench.lib import spec

    sp = spec.cell_spec(args.workload, args.root, os.path.join(args.root, "portbench"))
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    fn = {"train_zoo": r101, "train_dp": dp4}[sp["workload"]["driver"]]
    if args.diverge:
        def fn(cfg, wl, seed, dev):
            return diverge(cfg, wl, seed, dev, args.diverge)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.time()
        res = fn(sp["config"], sp["workload"], seed, dev)
        print(json.dumps(dict(workload=args.workload, seed=seed, seconds=time.time() - t,
                              device=str(dev), **res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
