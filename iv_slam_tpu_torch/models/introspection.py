"""Introspection FCN: MobileNetV2-dilated encoder + C1-DeepSup decoder.

Port of ``iv_slam_tpu/models/introspection.py``. The network
predicts a per-pixel cost map of feature unreliability from a raw image
(the reference's jackal recipe: fc_dim=320, regression mode), and
``inference_cost_map`` is the TorchScript inference wrapper
(networks/models_light/models_light.py:18-28, stereo_kitti.cc:492-517):
resize to the network input, forward, resize to the image, sharpen with
sigmoid(20 (x - 0.5)), scale to a uint8 cost map.

In training mode (``net.train()``) the decoder also runs the
deep-supervision branch (``cbr_deepsup``, ``conv_last_deepsup``) off the
stage-14 tap and the network returns ``(pred, pred_deepsup)``, as the JAX
package's ``IntrospectionNet(train=True)``; its BatchNorms then use flax's
batch statistics (``layers.BatchNorm2d``).

On the card the convolutions run in float32 without TF32 and with
deterministic algorithms (``fcn_numerics``), so a cost map is bit-repeatable
from run to run.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..utils.profiling import span
from .layers import resize as _resize
from .mobilenet import MobileNetV2Dilated, _conv_bn

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class C1DeepSup(nn.Module):
    """3x3 conv-bn-relu + 1x1 head off the final map (``cbr``,
    ``conv_last``), and the deep-supervision pair off the stage-14 tap
    (networks/models/models.py:347-384, regression mode)."""

    def __init__(self, num_class: int = 1, fc_dim: int = 320):
        super().__init__()
        self.cbr = nn.Sequential(*_conv_bn(fc_dim, fc_dim // 4, 3, relu6=False), nn.ReLU())
        self.conv_last = nn.Conv2d(fc_dim // 4, num_class, 1)
        self.cbr_deepsup = nn.Sequential(*_conv_bn(fc_dim // 2, fc_dim // 4, 3, relu6=False),
                                         nn.ReLU())
        self.conv_last_deepsup = nn.Conv2d(fc_dim // 4, num_class, 1)

    def forward(self, conv_out):
        x = self.conv_last(self.cbr(conv_out[-1]))
        if not self.training:
            return x
        return x, self.conv_last_deepsup(self.cbr_deepsup(conv_out[-2]))


class IntrospectionNet(nn.Module):
    """(B, 3, H, W) normalized image -> (B, 1, H/8, W/8) prediction; in
    training mode (pred, pred_deepsup). Built in eval mode."""

    def __init__(self):
        super().__init__()
        self.encoder = MobileNetV2Dilated()
        self.decoder = C1DeepSup()
        self.eval()

    def forward(self, x: torch.Tensor):
        return self.decoder(self.encoder(x))


_INV255 = float(np.float32(1.0 / 255.0))
_MEAN = [float(v) for v in np.float32(IMAGENET_MEAN)]
_INV_STD = [float(v) for v in np.float32(1.0) / np.float32(IMAGENET_STD)]


def normalize_image(img_u8: torch.Tensor) -> torch.Tensor:
    """uint8 RGB (..., H, W, 3) -> ImageNet-normalized float32; each
    division by a constant is a product with its float32 reciprocal, as
    jitted XLA:CPU computes it. The constants are Python numbers: a tensor
    made from them on the card would be an upload that syncs the host."""
    x = img_u8.to(torch.float32) * _INV255
    return torch.stack([(x[..., c] - _MEAN[c]) * _INV_STD[c] for c in range(3)], dim=-1)


def fcn_numerics(device: torch.device):
    """The numerics the FCN runs under: on the card, cuDNN without TF32 and
    with deterministic algorithms chosen without benchmarking."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                      allow_tf32=False)


@torch.no_grad()
def predict(model: IntrospectionNet, img_u8: torch.Tensor,
            net_hw: Tuple[int, int] = (512, 512)) -> torch.Tensor:
    """uint8 RGB (B, H, W, 3) -> the (B, 1, net_h / 8, net_w / 8) float32
    prediction: normalize, resize to net_hw, forward."""
    with span("fcn.preprocess"):
        x = normalize_image(img_u8).permute(0, 3, 1, 2).contiguous()
        x = _resize(x, net_hw)
    with span("fcn.forward"), fcn_numerics(x.device):
        return model(x)


@torch.no_grad()
def inference_cost_map(model: IntrospectionNet, img_u8: torch.Tensor,
                       out_hw: Tuple[int, int],
                       net_hw: Tuple[int, int] = (512, 512)) -> torch.Tensor:
    """uint8 RGB (H, W, 3) or (B, H, W, 3) -> uint8 cost map (H', W') or
    (B, H', W') at out_hw, on the image's device: ``predict``, resize to
    out_hw, sigmoid(20 (x - 0.5)), then clip(x * 255) truncated to uint8."""
    with span("fcn.cost_map"):
        pred = predict(model, img_u8 if img_u8.ndim == 4 else img_u8[None], net_hw)
        with span("fcn.postprocess"):
            pred = _resize(pred, out_hw)
            pred = torch.sigmoid(20.0 * (pred - 0.5))
            cost = torch.clamp(pred[:, 0] * 255.0, 0, 255).to(torch.uint8)
    return cost[0] if img_u8.ndim == 3 else cost
