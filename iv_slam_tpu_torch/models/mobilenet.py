"""MobileNetV2-dilated encoder (NCHW), the introspection FCN's backbone.

Port of ``iv_slam_tpu/models/mobilenet.py``: the ImageNet MobileNetV2
feature stack minus its final 1x1x1280 layer (18 stages), with output
stride 8 by dilation (the reference's MobileNetV2Dilated surgery,
networks/models/models.py:291-345): stages 7-13 run at dilation 2 and
stages 14-17 at dilation 4, their stride-2 depthwise convs flattened to
stride 1.

Parameter names are the upstream PyTorch modules' (``features.N.conv.M``),
so an upstream encoder snapshot loads with ``load_state_dict``. Its
BatchNorms are ``layers.BatchNorm2d``: flax's statistics in training mode.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from .layers import conv_bn

# (expansion t, channels c, repeats n, stride s) — standard MobileNetV2
INVERTED_RESIDUAL_SETTING = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)
DOWN_IDX = (2, 4, 7, 14)


def _conv_bn(cin: int, cout: int, kernel: int = 1, stride: int = 1, dilation: int = 1,
             groups: int = 1, relu6: bool = True) -> List[nn.Module]:
    """[conv (no bias), BatchNorm(eps 1e-5)] + ReLU6 when relu6."""
    layers = list(conv_bn(cin, cout, kernel, stride, dilation, groups))
    if relu6:
        layers.append(nn.ReLU6())
    return layers


class ConvBN(nn.Sequential):
    """conv-bn(-relu6), indexed 0/1(/2) as upstream's Sequential."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1, groups: int = 1, relu6: bool = True):
        super().__init__(*_conv_bn(cin, cout, kernel, stride, dilation, groups, relu6))


class InvertedResidual(nn.Module):
    """Expand 1x1 (when t != 1), depthwise 3x3, project 1x1; a residual
    when the stride is 1 and the width is kept. ``conv`` holds the layers at
    upstream's indices (0-7, or 0-4 without the expansion)."""

    def __init__(self, cin: int, cout: int, stride: int = 1, expand: int = 6,
                 dilation: int = 1):
        super().__init__()
        hidden = round(cin * expand)
        self.use_res = stride == 1 and cin == cout
        layers = []
        if expand != 1:
            layers += _conv_bn(cin, hidden, 1)
        layers += _conv_bn(hidden, hidden, 3, stride, dilation, groups=hidden)
        layers += _conv_bn(hidden, cout, 1, relu6=False)
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return x + y if self.use_res else y


def _dilated_plan() -> List[Tuple[int, int, int, int]]:
    """Per-stage (channels, stride, expand, dilation) of features[1..17]
    after the output-stride-8 surgery."""
    stages = []
    for t, c, n, s in INVERTED_RESIDUAL_SETTING:
        for i in range(n):
            stages.append((c, s if i == 0 else 1, t))
    plan = []
    for idx, (c, s, t) in enumerate(stages, start=1):
        if idx < 7:
            dil, stride = 1, s
        elif idx < 14:
            # dilate=2 region: stride-2 conv -> stride 1 dilation 1
            dil = 1 if s == 2 else 2
            stride = 1 if s == 2 else s
        else:
            # dilate=4 region: stride-2 conv -> stride 1 dilation 2
            dil = 2 if s == 2 else 4
            stride = 1 if s == 2 else s
        plan.append((c, stride, t, dil))
    return plan


class MobileNetV2Dilated(nn.Module):
    """Output-stride-8 encoder on (B, 3, H, W). Returns [tap2, tap4, tap7,
    tap14, final]."""

    def __init__(self):
        super().__init__()
        layers: List[nn.Module] = [ConvBN(3, 32, 3, stride=2)]
        cin = 32
        for c, stride, t, dil in _dilated_plan():
            layers.append(InvertedResidual(cin, c, stride, t, dil))
            cin = c
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        x = self.features[0](x)
        for idx in range(1, len(self.features)):
            x = self.features[idx](x)
            if idx in DOWN_IDX:
                taps.append(x)
        taps.append(x)
        return taps
