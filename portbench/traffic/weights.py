"""Seeded FCN weights, made on the device in two large draws and handed to
both the system under test and the plain reference: convolutions
He-normal, BatchNorm scales near 1, shifts and running means near 0,
running variances in [0.5, 1.5), biases 0."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import seeds


def fcn_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    g = torch.Generator(device=device).manual_seed(seeds.child(seed, 103))
    n = {k: int(torch.Size(s).numel()) for k, s in shapes.items()}
    normal = torch.randn(sum(n.values()), generator=g, device=device)
    uniform = torch.rand(sum(n.values()), generator=g, device=device)
    out, at = {}, 0
    for k, s in shapes.items():
        z = normal[at:at + n[k]].view(s)
        u = uniform[at:at + n[k]].view(s)
        at += n[k]
        if len(s) == 4:
            v = z * (2.0 / (s[1] * s[2] * s[3])) ** 0.5
        elif k.endswith(".running_var"):
            v = 0.5 + u
        elif k.endswith(".bias") and "conv_last" in k:
            v = torch.zeros_like(z)
        elif k.endswith(".bias") or k.endswith(".running_mean"):
            v = 0.1 * z
        else:
            v = 1.0 + 0.1 * z
        out[k] = v.contiguous()
    return out


def centre_head(w: Dict[str, torch.Tensor], pred: torch.Tensor, key: str = "decoder.conv_last"):
    """Scale and shift the 1x1 head so that the raw prediction ``pred`` of
    these weights has median 0.5 and a 10-90% spread of 0.3: the sharpened
    map sigmoid(20 (x - 0.5)) then spans the uint8 range, as a trained
    network's does."""
    q = torch.quantile(pred.double().flatten()[:1 << 24],
                       torch.tensor([0.1, 0.5, 0.9], dtype=torch.float64, device=pred.device))
    a = 0.3 / max(float(q[2] - q[0]), 1e-6)
    w[key + ".weight"] = (w[key + ".weight"] * a).contiguous()
    w[key + ".bias"] = (0.5 + (w[key + ".bias"] - float(q[1])) * a).contiguous()
    return w
