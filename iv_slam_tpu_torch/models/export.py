"""Model export for deployment (training/export_model_light.py's role).

Port of ``iv_slam_tpu/models/export.py``. The reference traces the
inference network to TorchScript (``torch.jit.trace`` -> a .pt file that
libtorch loads, stereo_kitti.cc:231-247); the JAX package serialises
StableHLO instead. The port writes TorchScript again: a trace of the whole
``inference_cost_map`` (normalize, resize to the network input, forward,
resize to the image, sharpen with sigmoid(20 (x - 0.5)), uint8) for one
(H, W, 3) uint8 image, the weights inside as constants.

Two things a trace does not carry, which ``load_inference`` restores:
  * the device: the graph runs where it was traced, unless loaded with
    another ``map_location``;
  * the numerics: ``fcn_numerics`` (cuDNN without TF32, deterministic
    algorithms) is a context around the call, not part of the graph, and
    TorchScript's executor may fuse elementwise ops (another rounding).
    The loaded callable enters that context and runs the graph without
    the executor's optimizations, so its map equals the eager one.
"""

from __future__ import annotations

import os
import warnings
from typing import Tuple

import torch
from torch import nn

from .introspection import fcn_numerics, inference_cost_map


class _CostMap(nn.Module):
    def __init__(self, net: nn.Module, out_hw: Tuple[int, int], net_hw: Tuple[int, int]):
        super().__init__()
        self.net = net
        self.out_hw, self.net_hw = tuple(out_hw), tuple(net_hw)

    def forward(self, img_u8: torch.Tensor) -> torch.Tensor:
        return inference_cost_map(self.net, img_u8, self.out_hw, self.net_hw)


def export_inference(net: nn.Module, out_path: str, out_hw: Tuple[int, int],
                     net_hw: Tuple[int, int] = (512, 512)) -> bytes:
    """Trace the cost-map inference of `net` (an IntrospectionNet, on the
    device it will run on) for (out_h, out_w, 3) uint8 RGB images and
    write the TorchScript module to `out_path`. Returns the file's bytes."""
    net.eval()
    dev = next(net.parameters()).device
    example = torch.zeros((out_hw[0], out_hw[1], 3), dtype=torch.uint8, device=dev)
    with torch.no_grad(), fcn_numerics(dev), warnings.catch_warnings():
        # the size checks of the resizes are fixed by out_hw and net_hw
        warnings.simplefilter("ignore", torch.jit.TracerWarning)
        traced = torch.jit.trace(_CostMap(net, out_hw, net_hw), example, check_trace=False)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    traced.save(out_path)
    with open(out_path, "rb") as f:
        return f.read()


def load_inference(path: str, device=None):
    """The exported module at `path` as a callable img_u8 (H, W, 3) ->
    uint8 (H, W) cost map, on `device` (the card unless the CPU is
    named)."""
    from ..slam import resolve_device

    dev = resolve_device(device, "load_inference")
    mod = torch.jit.load(path, map_location=dev)

    def run(img_u8: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), fcn_numerics(dev), torch.jit.optimized_execution(False):
            return mod(img_u8.to(dev))

    return run
