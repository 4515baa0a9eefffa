"""FLOPs of PSPNet-101 (reference/resnet_ppm.py) from its shapes, counted as
counts/fcn.py counts the flagship: every convolution's multiply-adds times
2, nothing else (the pools, BatchNorms, resizes and the concatenation are
left out); a training sample is 3 forwards (the backward's two products
per convolution) of the training network, whose deep-supervision branch
runs too."""

from __future__ import annotations

from ..reference.resnet_ppm import conv_plan
from .fcn import _out


def _grid(hw, grid):
    """The output size of a plan entry's ``grid`` at input size hw."""
    if isinstance(grid, int):
        return grid, grid
    sizes = [tuple(hw)]
    for _ in range({"s2": 1, "s4": 2, "s8": 3}[grid]):
        sizes.append(tuple(_out(n, 3, 2, 1) for n in sizes[-1]))
    return sizes[-1]


def forward_flops(arch: dict, hw, train: bool) -> int:
    """FLOPs of one sample's forward at input hw; ``train`` adds the
    deep-supervision branch."""
    total = 0
    for c in conv_plan(arch):
        if c["block"] == "deepsup" and not train:
            continue
        ho, wo = _grid(hw, c["grid"])
        total += 2 * c["cout"] * c["cin"] * c["k"] * c["k"] * ho * wo
    return total


def train_sample_flops(arch: dict, hw) -> int:
    return 3 * forward_flops(arch, hw, train=True)
