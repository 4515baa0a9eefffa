"""FLOPs of the introspection FCN from its shapes: every convolution's
multiply-adds times 2 (depthwise ones included), nothing else; a training
sample is 3 forwards (the backward's two products per convolution) of the
training network, whose deep-supervision branch runs too."""

from __future__ import annotations

from ..reference.fcn import conv_plan


def _out(n: int, k: int, stride: int, dil: int) -> int:
    pad = dil * (k // 2)
    return (n + 2 * pad - dil * (k - 1) - 1) // stride + 1


def forward_flops(arch: dict, hw, train: bool) -> int:
    """FLOPs of one sample's forward at input hw; ``train`` adds the
    deep-supervision branch."""
    h, w = hw
    total = 0
    for c in conv_plan(arch):
        if c["block"] == "deepsup" and not train:
            continue
        ho, wo = _out(h, c["k"], c["stride"], c["dil"]), _out(w, c["k"], c["stride"], c["dil"])
        total += 2 * c["cout"] * (c["cin"] // c["groups"]) * c["k"] * c["k"] * ho * wo
        if isinstance(c["block"], int):
            h, w = ho, wo   # the head and its deep-supervision twin keep the final size
    return total


def train_sample_flops(arch: dict, hw) -> int:
    return 3 * forward_flops(arch, hw, train=True)
