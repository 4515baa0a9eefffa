"""Training a model-zoo pair through the port's Trainer: ``Trainer.step``
(upload, forward with deep supervision and active dropout, masked MSE,
backward, SGD with the poly schedule) on the pair the configuration's
``fcn`` names, on batches drawn in seeded order from a pool made on the
card from the seed and held in pinned memory, a closed loop as fast as the
card goes. The reader of PNGs is bypassed.

As drivers/train.py: set-up builds one Trainer, loads the seeded weights
(made under the reference's upstream names, reference/resnet_ppm.py, and
carried to the port's by ``port_key``) and drives its first steps through
the window's call and feed; a forward hook on every dropout module records
the keep masks of the checked steps, which the reference applies. After
the window the plain reference follows the same steps from the same
weights, batches and masks, and ``compare`` gives the numbers the checks
hold: ``train.compare``'s, and the worst leaf of what step 1 changed.

Traced, the program's spans are recorded over the window and credited with
``lib/program_trace.RuntimeTrace``: the median device time of the
``fcn.encoder`` and ``fcn.decoder`` spans (the forward's kernels; autograd
launches the backward's under ``train.backward``) goes to the result's
data, and the span table to standard error."""

from __future__ import annotations

import json
import re
import sys
import time

import torch

from ..counts import resnet_ppm as counts
from ..lib import program_trace
from ..lib.trace import Spans
from ..reference import resnet_ppm as ref
from ..traffic import samples, weights
from . import common
from .train import CHECKED_STEPS, _order, leaf_gap, reference_feed
from .train import compare as train_compare

_STEM = re.compile(r"encoder\.(conv|bn)(\d)$")
_BLOCK = re.compile(r"encoder\.layer(\d)\.(\d+)\.(conv\d|bn\d|downsample\.\d)$")
_DECODER = {
    "decoder.conv_last.0": "decoder.ConvBNAct_0.Conv_0",
    "decoder.conv_last.1": "decoder.ConvBNAct_0.BatchNorm_0",
    "decoder.conv_last.4": "decoder.conv_last",
    "decoder.cbr_deepsup.0": "decoder.ConvBNAct_1.Conv_0",
    "decoder.cbr_deepsup.1": "decoder.ConvBNAct_1.BatchNorm_0",
    "decoder.conv_last_deepsup": "decoder.conv_last_deepsup",
}


def port_key(key: str, layers) -> str:
    """An upstream key of PSPNet-101 (reference/resnet_ppm.py) -> the key of
    the same tensor in the port's ``zoo.SegmentationModel``, whose modules
    carry flax's names."""
    module, field = key.rsplit(".", 1)
    m = _STEM.match(module)
    if m:
        part = "Conv_0" if m.group(1) == "conv" else "BatchNorm_0"
        return f"encoder.ConvBNAct_{int(m.group(2)) - 1}.{part}.{field}"
    m = _BLOCK.match(module)
    if m:
        stage, b, leaf = int(m.group(1)), int(m.group(2)), m.group(3)
        k = sum(layers[:stage - 1]) + b
        if leaf.startswith("downsample"):
            cba, part = 3, ("Conv_0" if leaf.endswith("0") else "BatchNorm_0")
        else:
            cba, part = int(leaf[-1]) - 1, ("Conv_0" if leaf.startswith("conv") else
                                            "BatchNorm_0")
        return f"encoder.Bottleneck_{k}.ConvBNAct_{cba}.{part}.{field}"
    m = re.match(r"decoder\.ppm\.(\d+)\.(\d)$", module)
    if m:
        part = "Conv_0" if m.group(2) == "1" else "BatchNorm_0"
        return f"decoder.PPMCore_0.ConvBNAct_{m.group(1)}.{part}.{field}"
    return f"{_DECODER[module]}.{field}"


class MaskTap:
    """Forward hooks on every dropout module of `net`: while ``on``, each
    call's keep mask in call order (``out != 0``; where the input is 0 the
    mask changes neither the value nor, through the ReLU before it, the
    gradient, and reads kept)."""

    def __init__(self, net: torch.nn.Module):
        self.masks, self.on = [], True
        self.handles = [m.register_forward_hook(self._hook) for m in net.modules()
                        if isinstance(m, (torch.nn.Dropout, torch.nn.Dropout2d))]
        if not self.handles:
            raise ValueError("the network has no dropout to record")

    def _hook(self, mod, inp, out):
        if self.on and mod.training:
            self.masks.append(((out != 0) | (inp[0] == 0)).detach())

    def close(self) -> None:
        for h in self.handles:
            h.remove()
        self.on = False


def setup(cfg: dict, wl: dict, seed: int, dev):
    """drivers/train.py's ``setup`` for the configuration's zoo pair, with
    the checked steps' dropout masks under ``first["masks"]`` (two a step),
    the weights and statistics after step 1 under ``first["step1"]``, and
    ``first``'s tensors under the upstream keys."""
    from iv_slam_tpu_torch.train.trainer import TrainConfig, Trainer

    arch, B, hw, rc = cfg["fcn"], cfg["batch_size"], tuple(cfg["input_hw"]), cfg["recipe"]
    pool = samples.fcn_pool(seed, wl["pool"], hw, dev, cfg["target_stride"])
    host = {k: (v.cpu().pin_memory() if dev.type == "cuda" else v.cpu()).numpy()
            for k, v in pool.items()}
    del pool
    trainer = Trainer(TrainConfig(
        num_epochs=rc["num_epochs"], batch_size=B, lr_encoder=rc["lr"],
        lr_decoder=rc.get("lr_decoder", rc["lr"]), momentum=rc["momentum"],
        weight_decay=rc["weight_decay"], lr_pow=rc["lr_pow"],
        deep_sup_scale=rc["deep_sup_scale"], input_hw=hw, arch_encoder=arch["arch_encoder"],
        arch_decoder=arch["arch_decoder"], fc_dim=arch["fc_dim"],
        num_class=arch["num_class"]), device=dev)
    w = weights.fcn_weights(ref.param_shapes(arch), seed, dev)
    keys = {k: port_key(k, arch["layers"]) for k in w}
    net = trainer.net
    sd = net.state_dict()
    missing = sorted(set(keys.values()) - set(sd))
    if missing:
        raise KeyError(f"weights the network does not have: {missing[:5]}")
    sd.update({keys[k]: v for k, v in w.items()})
    net.load_state_dict(sd)
    params = dict(net.named_parameters())
    order = _order(seed, wl["pool"] // B)

    def batch():
        j = next(order) * B
        return {k: v[j:j + B] for k, v in host.items()}, j

    tap = MaskTap(net)
    first = dict(loss=[], rows=[])
    for s in range(wl["warmup_steps"]):
        b, j = batch()
        first["rows"].append(j)
        first["loss"].append(float(trainer.step(b)["loss"]))
        if s == 0:
            now = net.state_dict()
            first["step1"] = {k: now[keys[k]].detach().clone() for k in w}
            opt = trainer.state.optimizer
            first["update"] = {}
            for k in w:
                if ref.is_buffer(k):
                    continue
                p = params[keys[k]]
                first["update"][k] = (opt.state[p]["momentum_buffer"].detach().clone()
                                      if "momentum_buffer" in opt.state[p] else
                                      torch.zeros_like(p))
        if s == CHECKED_STEPS - 1:
            now = net.state_dict()
            first["params"] = {k: now[keys[k]].detach().clone() for k in w}
            tap.close()
    first["loss"] = first["loss"][:CHECKED_STEPS]
    n = len(tap.masks) // CHECKED_STEPS
    first["masks"] = [tap.masks[s * n:(s + 1) * n] for s in range(CHECKED_STEPS)]
    return trainer, host, batch, w, first


def compare(got: dict, want: dict, w: dict) -> dict:
    """``train.compare``'s numbers and ``step1_gap``: the worst leaf's gap of
    the change step 1 made, over the weights and over the BatchNorm
    statistics, each against its own median leaf. Step 1 starts from the
    same weights on both sides, so round-off has not yet been amplified
    there: it holds each group's learning rate, the weight decay and every
    BatchNorm's batch statistics of the first forward."""
    out = train_compare(got, want, w)
    d_got = {k: got["step1"][k] - w[k] for k in w}
    d_want = {k: want["step1"][k] - w[k] for k in w}
    out["step1_gap"] = max(leaf_gap(d_got, d_want, [k for k in w if ref.is_buffer(k)]),
                           leaf_gap(d_got, d_want, [k for k in w if not ref.is_buffer(k)]))
    return out


def run(ctx) -> dict:
    from iv_slam_tpu_torch.utils import profiling

    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    B, hw = cfg["batch_size"], tuple(cfg["input_hw"])
    trainer, host, batch, w, first = setup(cfg, wl, ctx.seed, dev)
    spans = Spans()
    dt = program_trace.RuntimeTrace(dev) if ctx.trace else None
    prev = profiling.install(profiling.StageTimer()) if dt else None
    try:
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
            summary = dt.summary(t0, t1)
            rows = program_trace.program_rows(summary)["rows"]
    finally:
        if dt:
            profiling.install(prev)
    data = dict(samples=n * B, sample_flops=counts.train_sample_flops(cfg["fcn"], hw))
    device = []
    if dt:
        for part in ("encoder", "decoder"):
            data[part + "_device_s"] = program_trace.per_span(
                [rows], "fcn." + part, 2, t0, t1, 1e-9) or 0.0
        print("portbench: program spans " + json.dumps(program_trace.span_table([rows], t0, t1)),
              file=sys.stderr)
        device = [summary]
    peak = common.peak_bytes(dev)
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    del trainer, losses
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    r = ref.train_steps(cfg["fcn"], cfg["recipe"], w,
                        reference_feed(cfg, host, first["rows"], dev), first["masks"])
    got = compare(first, r, w)
    lim = wl["limits"]
    return dict(
        t0_ns=t0, t1_ns=t1, attempted=n, failed=failed,
        e2e=dict(train_samples_per_s=n * B / ((t1 - t0) * 1e-9)),
        checks=[(k, float(got[k]), lim[k]) for k in lim],
        memory_peak_bytes=peak, spans=spans.spans, device=device, data=data)

