"""The per-frame introspection path (stereo_kitti.cc:492-521) over several
streams at once, one process each, as several cameras' frames or a
dataset's sequences are cost-mapped on one card: each stream is a closed
loop at batch 1 over its own ring of colour camera frames in pinned host
memory. Each frame is uploaded, run through ``models.inference_cost_map``
(the network at its input size, the map at the image's size) and its uint8
cost map downloaded into pinned memory; the stream waits for it before it
sends its next frame. The streams share one seeded network; a barrier
starts every window at once.

Checked in each stream: the cost maps of ring frames drawn from the seed,
as the window last delivered them, against the plain reference's
(reference/fcn.py) on the same frames and weights: the largest difference
in grey levels and the share of pixels that differ."""

from __future__ import annotations

import time

from ..counts import fcn as fcn_counts
from ..reference import fcn as ref
from . import common


def check_indices(seed: int, k: int, wl: dict, delivered: int, ring: int):
    """The ring slots stream k checks."""
    return common.sample(seed, 600 + k, min(delivered, ring), wl["check_frames"])


def reference_map(cfg: dict, w: dict, img, precision: str = "fp32"):
    """The reference's (H, W) uint8 cost map of one (H, W, 3) uint8 frame."""
    p, stats = common.split(w)
    cam = cfg["camera"]
    return ref.cost_map(cfg["fcn"], p, stats, img[None], (cam["height"], cam["width"]),
                        tuple(cfg["net_hw"]), precision)[0]


def stream_setup(cfg: dict, wl: dict, seed: int, k: int, dev):
    """(the seeded network, the weights both sides get, stream k's ring on
    the card): the network's head is centred on one frame made from the
    seed, so every stream holds the same network; each stream's ring is
    made from the seed and its index."""
    from ..traffic import samples, seeds

    hw = (cfg["camera"]["height"], cfg["camera"]["width"])
    net, w = common.seeded_fcn(cfg, seed, dev, calib_rgb=samples.colour_ring(seed, 1, hw, dev))
    return net, w, samples.colour_ring(seeds.child(seed, 700, k), wl["ring_frames"], hw, dev)


def _stream_body(k, seed, cfg, wl, seconds, trace, device, conn) -> dict:
    import torch
    from iv_slam_tpu_torch import models

    from ..lib.trace import DeviceTrace, Spans

    dev = torch.device(device)
    H, W = cfg["camera"]["height"], cfg["camera"]["width"]
    net_hw = tuple(cfg["net_hw"])
    net, w, ring = stream_setup(cfg, wl, seed, k, dev)
    src = ring.cpu()
    out = torch.empty((len(src), H, W), dtype=torch.uint8)
    if dev.type == "cuda":
        src, out = src.pin_memory(), out.pin_memory()
    del ring
    spans = Spans()

    def frame(i):
        j = i % len(src)
        with spans.span("frame"):
            img = src[j].to(dev, non_blocking=True)
            cost = models.inference_cost_map(net, img, (H, W), net_hw)
            out[j].copy_(cost, non_blocking=True)
            common.sync(dev)

    for i in range(wl["warmup_frames"]):
        frame(i)
    dt = DeviceTrace(dev) if trace else None
    if dt:
        dt.start()
    common.sync(dev)
    conn.send(("ready", time.time_ns()))
    t0 = conn.recv()
    t_end = t0 + int(seconds * 1e9)
    common.wait_until(t0)
    n = 0
    while True:
        frame(n)
        if spans.spans[-1][2] > t_end:
            break
        n += 1
    if dt:
        dt.stop()
    peak = common.peak_bytes(dev)
    del net
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the check, after the window: sampled slots, as last delivered
    gap = common.MapGap()
    for j in check_indices(seed, k, wl, n + 1, len(src)):
        gap.add(out[j], reference_map(cfg, w, src[j].to(dev)))
    return dict(frames=n, peak=peak, spans=spans.spans, t_window=(t0, t_end),
                cost_max_diff=gap.worst, cost_diff_px=gap.diff_px, cost_px=gap.px,
                device=dt.summary(t0, t_end) if dt else None)


def run(ctx) -> dict:
    res = common.run_clients(_stream_body, ctx.workload["streams"], (
        ctx.seed, ctx.config, ctx.workload, ctx.seconds, ctx.trace, str(ctx.device)),
        ctx.seconds)
    return aggregate(ctx, res)


def aggregate(ctx, res) -> dict:
    """The run's outcome from the streams' results: a frame counts when its
    map was delivered inside the window."""
    t0, t_end = res[0]["t_window"]
    frames = sum(r["frames"] for r in res)
    lim = ctx.workload["limits"]
    cost_px = sum(r["cost_px"] for r in res)
    return dict(
        t0_ns=t0, t1_ns=t_end, attempted=frames, failed=0,
        e2e=dict(costmap_fps=frames / ((t_end - t0) * 1e-9)),
        checks=[("cost_max_diff", float(max(r["cost_max_diff"] for r in res)),
                 lim["cost_max_diff"]),
                ("cost_diff_share", sum(r["cost_diff_px"] for r in res) / max(cost_px, 1),
                 lim["cost_diff_share"])],
        memory_peak_bytes=sum(r["peak"] for r in res),
        spans=[s for r in res for s in r["spans"]],
        device=[r["device"] for r in res if r["device"]],
        data=dict(frames=frames, forward_flops=fcn_counts.forward_flops(
            ctx.config["fcn"], tuple(ctx.config["net_hw"]), train=False)),
        forbidden=common.forbidden(res))
