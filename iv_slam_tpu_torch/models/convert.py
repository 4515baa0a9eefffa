"""Weights for the port's introspection FCN.

The port's modules carry the upstream PyTorch names that
``iv_slam_tpu/models/convert_torch.py`` reads (``features.N...`` for the
MobileNetV2 encoder; ``cbr``, ``conv_last``, ``cbr_deepsup``,
``conv_last_deepsup`` for the C1-DeepSup decoder), so an upstream
encoder/decoder snapshot (training/train_modular.py's encoder_*.pth /
decoder_*.pth) loads with ``load_state_dict``: ``convert_checkpoint``.

``from_jax_variables`` carries a Flax variables tree of the JAX package's
``IntrospectionNet`` or of a model-zoo network across: HWIO kernels become
OIHW (a depthwise (kH, kW, 1, C) becomes (C, 1, kH, kW)), and BatchNorm
scale/bias/mean/var become weight/bias/running_mean/running_var. The zoo's
modules carry flax's own names (``models/zoo.py``), so their entries map
by path.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .introspection import IntrospectionNet
from .mobilenet import _dilated_plan


def _kernel(k) -> torch.Tensor:
    # flax (kH, kW, I, O) -> torch (O, I, kH, kW); depthwise (kH, kW, 1, C)
    # -> (C, 1, kH, kW) by the same transpose
    return torch.from_numpy(np.array(np.transpose(np.asarray(k), (3, 2, 0, 1)), np.float32))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _put_convbn(sd, conv: str, bn: str, params, stats):
    sd[conv + ".weight"] = _kernel(params["Conv_0"]["kernel"])
    p, s = params["BatchNorm_0"], stats["BatchNorm_0"]
    sd[bn + ".weight"] = _t(p["scale"])
    sd[bn + ".bias"] = _t(p["bias"])
    sd[bn + ".running_mean"] = _t(s["mean"])
    sd[bn + ".running_var"] = _t(s["var"])
    sd[bn + ".num_batches_tracked"] = torch.tensor(0)


def _mobilenet(sd, prefix: str, pe, se) -> None:
    _put_convbn(sd, f"{prefix}features.0.0", f"{prefix}features.0.1", pe["ConvBN_0"],
                se["ConvBN_0"])
    for i, (_, _, t, _) in enumerate(_dilated_plan()):
        blk = f"{prefix}features.{i + 1}.conv"
        name = f"InvertedResidual_{i}"
        # upstream's Sequential indices of the conv layers: [pw,] dw, pw-linear
        convs = (0, 3, 6) if t != 1 else (0, 3)
        for j, c in enumerate(convs):
            _put_convbn(sd, f"{blk}.{c}", f"{blk}.{c + 1}", pe[name][f"ConvBN_{j}"],
                        se[name][f"ConvBN_{j}"])


def _c1_deepsup(sd, prefix: str, pd, sdec) -> None:
    _put_convbn(sd, f"{prefix}cbr.0", f"{prefix}cbr.1", pd["ConvBN_0"], sdec["ConvBN_0"])
    sd[f"{prefix}conv_last.weight"] = _kernel(pd["conv_last"]["kernel"])
    sd[f"{prefix}conv_last.bias"] = _t(pd["conv_last"]["bias"])
    if "ConvBN_1" in pd:
        _put_convbn(sd, f"{prefix}cbr_deepsup.0", f"{prefix}cbr_deepsup.1", pd["ConvBN_1"],
                    sdec["ConvBN_1"])
        sd[f"{prefix}conv_last_deepsup.weight"] = _kernel(pd["conv_last_deepsup"]["kernel"])
        sd[f"{prefix}conv_last_deepsup.bias"] = _t(pd["conv_last_deepsup"]["bias"])


def _by_path(sd, prefix: str, params, stats) -> None:
    """The zoo's modules carry flax's names: a Conv leaf dict ({kernel,
    bias}) and a BatchNorm's ({scale, bias} + stats {mean, var}) map to the
    module at the same path."""
    for k, v in params.items():
        if "kernel" in v:
            sd[f"{prefix}{k}.weight"] = _kernel(v["kernel"])
            if "bias" in v:
                sd[f"{prefix}{k}.bias"] = _t(v["bias"])
        elif "scale" in v:
            sd[f"{prefix}{k}.weight"] = _t(v["scale"])
            sd[f"{prefix}{k}.bias"] = _t(v["bias"])
            sd[f"{prefix}{k}.running_mean"] = _t(stats[k]["mean"])
            sd[f"{prefix}{k}.running_var"] = _t(stats[k]["var"])
            sd[f"{prefix}{k}.num_batches_tracked"] = torch.tensor(0)
        else:
            _by_path(sd, f"{prefix}{k}.", v, stats.get(k, {}))


def _module(sd, prefix: str, params, stats) -> None:
    if "InvertedResidual_0" in params:
        _mobilenet(sd, prefix, params, stats)
    elif "ConvBN_0" in params:
        _c1_deepsup(sd, prefix, params, stats)
    else:
        _by_path(sd, prefix, params, stats)


def from_jax_variables(variables) -> Dict[str, torch.Tensor]:
    """Flax variables ({"params", "batch_stats"}, as numpy or jax arrays) of
    the JAX package's ``IntrospectionNet`` or ``zoo.SegmentationModel`` (an
    "encoder" and a "decoder"), or of one zoo encoder or decoder alone -> a
    state dict of the port's counterpart. The deep-supervision entries come
    along when the Flax tree has them (a network initialized for
    training)."""
    P, S = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    if "encoder" in P or "decoder" in P:
        for part in ("encoder", "decoder"):
            _module(sd, f"{part}.", P[part], S.get(part, {}))
    else:
        _module(sd, "", P, S)
    return sd


def convert_checkpoint(encoder_pth: str, decoder_pth: str) -> IntrospectionNet:
    """An ``IntrospectionNet`` holding the upstream encoder/decoder .pth
    snapshots (loaded on the CPU; move the network with ``.to``)."""
    net = IntrospectionNet()
    net.encoder.load_state_dict(torch.load(encoder_pth, map_location="cpu"))
    net.decoder.load_state_dict(torch.load(decoder_pth, map_location="cpu"))
    return net
