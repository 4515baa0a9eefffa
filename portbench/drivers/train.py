"""FCN training on batches held in pinned host memory: ``Trainer.step`` (the
port's step: upload, forward with deep supervision, masked MSE, backward,
SGD with the poly schedule) on batches drawn in seeded order from a pool
made on the card from the seed, a closed loop as fast as the card goes.
The reader of PNGs is bypassed: the step is the card's work.

Set-up builds one Trainer, loads the seeded weights into it and drives
its first steps through the same call and feed the window uses, each on
its own rows; the checks read what those steps left (the losses, the
optimizer's momentum after step 1, the weights and BatchNorm statistics
after step 3). After the window the plain reference (reference/fcn.py)
follows the same three steps from the same weights and batches."""

from __future__ import annotations

import time

import numpy as np
import torch

from ..counts import fcn as fcn_counts
from ..lib.trace import DeviceTrace, Spans
from ..reference import fcn as ref
from ..traffic import samples, seeds, weights
from . import common

CHECKED_STEPS = 3
# steps whose loss is compared: every later step's loss follows weights in
# which steps at lr 0.02 have amplified round-off, so that the reference
# against itself with its weights one ulp apart reads the second step's up
# to 1.5e-3 apart and the third's up to 1.5e-2 (PERF.md)
LOSS_STEPS = 1


def _order(seed: int, n_blocks: int):
    """Block indices of the pool in seeded order, epoch after epoch."""
    epoch = 0
    while True:
        yield from seeds.rng(seed, 200, epoch).permutation(n_blocks)
        epoch += 1


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_gaps(got: dict, want: dict, keys) -> dict:
    """Each leaf's |norm(got) - norm(want)| over the larger of the leaf's
    norm in `want` and the median leaf's."""
    keys = list(keys)
    ng = [float(torch.linalg.vector_norm(got[k].double())) for k in keys]
    nw = [float(torch.linalg.vector_norm(want[k].double())) for k in keys]
    med = float(np.median(nw))
    return {k: abs(g - w) / max(w, med, 1e-30) for k, g, w in zip(keys, ng, nw)}


def leaf_gap(got: dict, want: dict, keys) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(got, want, keys).values())


def setup(cfg: dict, wl: dict, seed: int, dev):
    """The Trainer with the seeded weights, the pinned pool, the batch
    order, and what its first steps (through the window's call and feed,
    each on its own rows) left for the checks: ``loss`` (the first
    CHECKED_STEPS), ``update`` (the momentum after step 1), ``params`` (the
    weights and statistics after step CHECKED_STEPS) and ``rows``."""
    from iv_slam_tpu_torch.train.trainer import TrainConfig, Trainer

    B, hw, rc = cfg["batch_size"], tuple(cfg["input_hw"]), cfg["recipe"]
    pool = samples.fcn_pool(seed, wl["pool"], hw, dev, cfg["target_stride"])
    host = {k: (v.cpu().pin_memory() if dev.type == "cuda" else v.cpu()).numpy()
            for k, v in pool.items()}
    del pool
    trainer = Trainer(TrainConfig(
        num_epochs=rc["num_epochs"], batch_size=B, lr_encoder=rc["lr"], lr_decoder=rc["lr"],
        momentum=rc["momentum"], weight_decay=rc["weight_decay"], lr_pow=rc["lr_pow"],
        deep_sup_scale=rc["deep_sup_scale"], input_hw=hw), device=dev)
    w = weights.fcn_weights(ref.param_shapes(cfg["fcn"]), seed, dev)
    net = trainer.net
    sd = net.state_dict()
    sd.update(w)
    net.load_state_dict(sd)
    order = _order(seed, wl["pool"] // B)

    def batch():
        j = next(order) * B
        return {k: v[j:j + B] for k, v in host.items()}, j

    first = dict(loss=[], rows=[])
    for s in range(wl["warmup_steps"]):
        b, j = batch()
        first["rows"].append(j)
        first["loss"].append(float(trainer.step(b)["loss"]))
        if s == 0:
            opt = trainer.state.optimizer
            # what SGD got as the step's gradient (none: the step never ran)
            first["update"] = {k: opt.state[p]["momentum_buffer"].detach().clone()
                               if "momentum_buffer" in opt.state[p] else torch.zeros_like(p)
                               for k, p in net.named_parameters()}
        if s == CHECKED_STEPS - 1:
            first["params"] = {k: v.detach().clone() for k, v in net.state_dict().items()
                               if k in w}
    first["loss"] = first["loss"][:CHECKED_STEPS]
    return trainer, host, batch, w, first


def reference_feed(cfg: dict, host: dict, rows, dev):
    """The batches of the checked steps as NCHW tensors for the reference."""
    B = cfg["batch_size"]

    def nchw(a, j):
        return torch.from_numpy(np.ascontiguousarray(a[j:j + B])).to(dev).permute(0, 3, 1, 2)

    return [tuple(nchw(host[k], j) for k in ("image", "target", "mask"))
            for j in rows[:CHECKED_STEPS]]


def compare(got: dict, want: dict, w: dict) -> dict:
    """The numbers the checks hold: ``got`` and ``want`` each with ``loss``,
    ``update`` and ``params`` (``want`` the reference's, with its raw step-1
    ``grad``). Leaves whose reference gradient is under a thousandth of the
    median leaf's are left out of the change: round-off alone moves them.
    The change is compared by its median leaf: three steps at lr 0.02 from
    a seeded init amplify round-off, so that the reference against itself
    with its weights one ulp apart reads its worst leaf's change as far
    apart as the program does (PERF.md); ``change_worst_gap`` is reported
    beside it."""
    p_keys = list(want["grad"])
    gnorm = {k: float(torch.linalg.vector_norm(want["grad"][k])) for k in p_keys}
    g_med = float(np.median(list(gnorm.values())))
    moved = [k for k in p_keys if gnorm[k] >= 1e-3 * g_med]
    d_got = {k: got["params"][k] - w[k] for k in w}
    d_want = {k: want["params"][k] - w[k] for k in w}
    steps = [rel_gap(a, b) for a, b in zip(got["loss"], want["loss"])]
    change = leaf_gaps(d_got, d_want, moved)
    return dict(
        loss_gap=max(steps[:LOSS_STEPS]),
        grad_gap=leaf_gap(got["update"], want["update"], p_keys),
        change_median_gap=float(np.median(list(change.values()))),
        stats_gap=leaf_gap(d_got, d_want, [k for k in w if ref.is_buffer(k)]),
        change_worst_gap=max(change.values()), change_worst_leaf=max(change, key=change.get),
        step_loss_gaps=steps, left_out=len(p_keys) - len(moved))


def run(ctx) -> dict:
    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    B, hw = cfg["batch_size"], tuple(cfg["input_hw"])
    trainer, host, batch, w, first = setup(cfg, wl, ctx.seed, dev)
    spans = Spans()
    dt = DeviceTrace(dev) if ctx.trace else None
    if dt:
        dt.start()
    common.sync(dev)
    t0 = time.time_ns()
    t_end = t0 + int(ctx.seconds * 1e9)
    losses, n = [], 0
    while True:
        with spans.span("step"):
            losses.append(trainer.step(batch()[0])["loss"])
        n += 1
        if time.time_ns() >= t_end:
            break
    common.sync(dev)
    t1 = time.time_ns()
    if dt:
        dt.stop()
    peak = common.peak_bytes(dev)
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    del trainer, losses
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    r = ref.train_steps(cfg["fcn"], cfg["recipe"], w,
                        reference_feed(cfg, host, first["rows"], dev))
    got = compare(first, r, w)
    lim = wl["limits"]
    return dict(
        t0_ns=t0, t1_ns=t1, attempted=n, failed=failed,
        e2e=dict(train_samples_per_s=n * B / ((t1 - t0) * 1e-9)),
        checks=[(k, float(got[k]), lim[k]) for k in lim],
        memory_peak_bytes=peak, spans=spans.spans,
        device=[dt.summary(t0, t1)] if dt else [],
        data=dict(samples=n * B, sample_flops=fcn_counts.train_sample_flops(cfg["fcn"], hw)))
