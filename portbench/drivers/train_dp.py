"""Data-parallel FCN training, one process and one card a rank: each rank
joins the group through ``parallel.mesh.init_data_parallel`` (NCCL with a
card each; gloo on the CPU, for rehearsals only: on CUDA a rank without a
card of its own, or a group not over NCCL, raises) and runs ``Trainer.step`` with its
``DataParallel`` on every global batch: its own rows (``batch_size`` of
the configuration) are uploaded and trained, every BatchNorm averages its
statistics over the group (``models.set_process_group``, Sync-BN) and the
gradients are summed over the ranks. The global batches are drawn in
seeded order from a pool made from the seed and held in pinned memory by
every rank, a closed loop as fast as the slowest card goes; rank 0 decides
when the window ends, through a gloo group of its own, so every rank runs
the same steps.

Set-up: every rank builds its Trainer with the same seeded weights and
drives the first steps through the window's call and feed. After step
``CHECKED_STEPS`` the ranks all-reduce the largest and the smallest of
every weight and statistic: their spread, ``rank_weight_gap``, is 0 when
every rank holds rank 0's weights. Rank 0 keeps what the checks read, as
drivers/train.py does; after the window the plain reference
(reference/fcn.py) follows the same steps on the whole global batches
(BatchNorm over all their rows) from the same weights.

Traced, each rank's device summary names its card (``chip``), the
program's spans are credited to the device trace and rank 0's span table
goes to standard error."""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from ..counts import fcn as fcn_counts
from ..lib import program_trace
from ..lib.trace import Spans
from ..reference import fcn as ref
from ..traffic import samples, weights
from . import common
from .train import CHECKED_STEPS, _order, compare, reference_feed


def global_batch(cfg: dict, wl: dict) -> int:
    return cfg["batch_size"] * wl["ranks"]


def _first_steps(trainer, batch, w: dict, wl: dict, dp) -> dict:
    """The warm-up steps; what they left for the checks (rank 0's
    ``loss``, ``update``, ``params`` and the steps' ``rows``) and the
    ranks' ``rank_weight_gap``."""
    import torch.distributed as dist

    net = trainer.net
    first = dict(loss=[], rows=[])
    for s in range(wl["warmup_steps"]):
        b, j = batch()
        first["rows"].append(j)
        first["loss"].append(float(trainer.step(b)["loss"]))
        if s == 0:
            opt = trainer.state.optimizer
            first["update"] = {k: opt.state[p]["momentum_buffer"].detach().clone()
                               if "momentum_buffer" in opt.state[p] else torch.zeros_like(p)
                               for k, p in net.named_parameters()}
        if s == CHECKED_STEPS - 1:
            first["params"] = {k: v.detach().clone() for k, v in net.state_dict().items()
                               if k in w}
            flat = torch.cat([first["params"][k].reshape(-1) for k in w])
            hi, lo = flat.clone(), flat.clone()
            dist.all_reduce(hi, dist.ReduceOp.MAX)
            dist.all_reduce(lo, dist.ReduceOp.MIN)
            first["rank_weight_gap"] = float((hi - lo).abs().max())
    first["loss"] = first["loss"][:CHECKED_STEPS]
    return first


def _own_cores(k: int, world: int) -> None:
    """Rank k on a block of the host's cores of its own (the parent keeps
    the first), where ``common`` pins a client to one: the threads NCCL and
    gloo start inherit it, and on one core they and any neighbour's load
    slow that rank's launches, and every collective waits for the slowest
    rank. Leaves the one core where there are fewer cores than ranks."""
    try:
        cpus = sorted(os.sched_getaffinity(os.getppid()))
        per = (len(cpus) - 1) // world
        if per > 1:
            os.sched_setaffinity(0, cpus[1 + k * per:1 + (k + 1) * per])
    except OSError:
        pass


def _rank_body(k, seed, cfg, wl, seconds, trace, device, port, conn) -> dict:
    import torch.distributed as dist
    from iv_slam_tpu_torch.parallel import mesh
    from iv_slam_tpu_torch.train.trainer import TrainConfig, Trainer
    from iv_slam_tpu_torch.utils import profiling

    _own_cores(k, wl["ranks"])
    world, rc = wl["ranks"], cfg["recipe"]
    B, hw = global_batch(cfg, wl), tuple(cfg["input_hw"])
    dev = mesh.rank_device(k, world, device)
    if dev.type == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} ranks need a card each, found {torch.cuda.device_count()}")
    dp = mesh.init_data_parallel(k, world, port, dev)
    try:
        if dev.type == "cuda" and dist.get_backend() != "nccl":
            raise RuntimeError(f"the ranks' group runs over {dist.get_backend()}, not nccl")
        ctl = dist.new_group(backend="gloo")
        pool = samples.fcn_pool(seed, wl["pool"], hw, dev, cfg["target_stride"])
        host = {n: (v.cpu().pin_memory() if dev.type == "cuda" else v.cpu()).numpy()
                for n, v in pool.items()}
        del pool
        trainer = Trainer(TrainConfig(
            num_epochs=rc["num_epochs"], batch_size=B, lr_encoder=rc["lr"],
            lr_decoder=rc["lr"], momentum=rc["momentum"], weight_decay=rc["weight_decay"],
            lr_pow=rc["lr_pow"], deep_sup_scale=rc["deep_sup_scale"], input_hw=hw),
            device=dev, dp=dp)
        w = weights.fcn_weights(ref.param_shapes(cfg["fcn"]), seed, dev)
        sd = trainer.net.state_dict()
        sd.update(w)
        trainer.net.load_state_dict(sd)
        order = _order(seed, wl["pool"] // B)

        def batch():
            j = next(order) * B
            return {n: v[j:j + B] for n, v in host.items()}, j

        first = _first_steps(trainer, batch, w, wl, dp)
        spans = Spans()
        dt = program_trace.RuntimeTrace(dev) if trace else None
        prev = profiling.install(profiling.StageTimer()) if dt else None
        try:
            if dt:
                dt.start()
            common.sync(dev)
            conn.send(("ready", time.time_ns()))
            t0 = conn.recv()
            t_end = t0 + int(seconds * 1e9)
            common.wait_until(t0)
            losses, n = [], 0
            stop = torch.zeros(1, dtype=torch.int32)
            while True:
                with spans.span("step"):
                    losses.append(trainer.step(batch()[0])["loss"])
                n += 1
                stop[0] = int(time.time_ns() >= t_end)
                dist.broadcast(stop, 0, group=ctl)
                if stop[0]:
                    break
            common.sync(dev)
            t1 = time.time_ns()
            summary = rows = None
            if dt:
                dt.stop()
                summary = dt.summary(t0, t1)
                summary["chip"] = dev.index or 0
                rows = program_trace.program_rows(summary)["rows"]
        finally:
            if dt:
                profiling.install(prev)
        if rows is not None and k == 0:
            print("portbench: rank 0's program spans "
                  + json.dumps(program_trace.span_table([rows], t0, t1)), file=sys.stderr)
        out = dict(steps=n, t_window=(t0, t1), peak=common.peak_bytes(dev), chip=dev.index or 0,
                   failed=int((~torch.isfinite(torch.stack(losses))).sum()),
                   spans=spans.spans, device=summary,
                   rank_weight_gap=first["rank_weight_gap"])
        del trainer, losses
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if k == 0:
            feed = reference_feed(dict(cfg, batch_size=B), host, first["rows"], dev)
            out["got"] = {n: float(v) for n, v in compare(
                first, ref.train_steps(cfg["fcn"], rc, w, feed), w).items()
                if isinstance(v, float)}
        dist.barrier(group=ctl)
        return out
    finally:
        dist.destroy_process_group()


def aggregate(ctx, res) -> dict:
    """The run's outcome from the ranks' results: every rank ran the same
    steps; the window ends when the last rank's closing sync returns. The
    readers' ``samples`` are each card's (its rank's rows of the window's
    steps), so that ``mfu_pct.train`` reads the cards' mean share of their
    peak; ``train_samples_per_s`` counts every rank's."""
    cfg, wl = ctx.config, ctx.workload
    B = global_batch(cfg, wl)
    t0 = res[0]["t_window"][0]
    t1 = max(r["t_window"][1] for r in res)
    n = res[0]["steps"]
    if any(r["steps"] != n for r in res):
        raise RuntimeError(f"the ranks ran {[r['steps'] for r in res]} steps")
    lim = wl["limits"]
    got = dict(res[0]["got"], rank_weight_gap=max(r["rank_weight_gap"] for r in res))
    return dict(
        t0_ns=t0, t1_ns=t1, attempted=n, failed=max(r["failed"] for r in res),
        chips=len({r["chip"] for r in res}),
        e2e=dict(train_samples_per_s=n * B / ((t1 - t0) * 1e-9)),
        checks=[(name, float(got[name]), lim[name]) for name in lim],
        memory_peak_bytes=sum(r["peak"] for r in res),
        spans=[s for r in res for s in r["spans"]],
        device=[r["device"] for r in res if r["device"]],
        data=dict(samples=n * cfg["batch_size"], steps=n, ranks=len(res),
                  sample_flops=fcn_counts.train_sample_flops(cfg["fcn"],
                                                             tuple(cfg["input_hw"]))),
        forbidden=common.forbidden(res))


def run(ctx) -> dict:
    from iv_slam_tpu_torch.parallel import mesh

    res = common.run_clients(_rank_body, ctx.workload["ranks"], (
        ctx.seed, ctx.config, ctx.workload, ctx.seconds, ctx.trace, ctx.device.type,
        mesh.free_port()), ctx.seconds)
    return aggregate(ctx, res)
