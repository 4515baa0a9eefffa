"""The introspection FCN's model zoo (NCHW).

Port of ``iv_slam_tpu/models/zoo.py``, the reference's ModelBuilder
encoder/decoder zoo (networks/models/models.py:77-177):

encoders
  mobilenetv2dilated            models/mobilenet.py (this package)
  resnet18 / resnet18dilated    deep 3-conv stem, BasicBlock/Bottleneck,
  resnet50 / resnet50dilated      layers [2,2,2,2] / [3,4,6,3] / [3,4,23,3]
  resnet101 / resnet101dilated    (models.py:190-291 over resnet.py)
  resnext101                    grouped Bottleneck, groups 32, expansion 2
  hrnetv2                       HRNetV2-W48: four-branch stages, the
                                branches upsampled and concatenated (720
                                channels at stride 4)

decoders
  c1 / c1_deepsup               models.py:346-436 (c1_deepsup is
                                introspection.C1DeepSup, the flagship's)
  ppm / ppm_deepsup             pyramid pooling 1/2/3/6 (models.py:439-533)
  upernet / upernet_lite        PPM head + FPN fusion, fpn_dim 512 / 256

Submodules carry the names flax gives the JAX package's modules
(``ConvBNAct_0``, ``Conv_0``, ``BatchNorm_0``, ``BasicBlock_3``,
``conv_last``, ...), so that ``convert.from_jax_variables`` carries a Flax
variables tree across by path. The MobileNetV2 encoder and the C1-DeepSup
decoder keep the upstream PyTorch names instead (their snapshots load with
``load_state_dict``). A decoder is given the channels of the encoder's
maps (Flax reads them from its inputs); ``encoder_channels`` lists them.

Dilation reproduces ``_nostride_dilate`` (models.py:258-271): a stride-2
conv becomes stride 1 with dilation d/2, the rest of the stage dilation d.
Resizes are ``jax.image.resize``'s bilinear (``layers.resize``). In
training mode the BatchNorms use flax's batch statistics and the PPM
decoders' dropout is active: ``nn.Dropout2d(0.1)``, whole channels of a
sample, as upstream's PPM and PPMDeepsup (models.py, ``nn.Dropout2d(0.1)`` in
``conv_last`` and ``dropout_deepsup``; the JAX package drops single
elements). Deep-supervision decoders return
``(pred, pred_deepsup)``.

``SegmentationModel.forward`` records the spans ``fcn.encoder`` and
``fcn.decoder`` (``utils.profiling.span``; a check with no recorder).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import span
from .layers import conv_bn, resize

ENCODER_FC_DIM = {
    "mobilenetv2dilated": 320,
    "resnet18": 512,
    "resnet18dilated": 512,
    "resnet50": 2048,
    "resnet50dilated": 2048,
    "resnet101": 2048,
    "resnet101dilated": 2048,
    "resnext101": 2048,
    "hrnetv2": 720,
}

PPM_DIM = 512
POOL_SCALES = (1, 2, 3, 6)


def encoder_channels(arch: str) -> Tuple[int, ...]:
    """Channels of the maps ``build_encoder(arch)`` returns."""
    arch = arch.lower()
    if arch == "mobilenetv2dilated":
        return (24, 32, 64, 160, 320)
    if arch == "hrnetv2":
        return (720,)
    if arch not in ENCODER_FC_DIM:
        raise ValueError(f"Architecture undefined: {arch!r}")
    c = ENCODER_FC_DIM[arch]
    return (c // 8, c // 4, c // 2, c)


class ConvBNAct(nn.Module):
    """conv -> BN -> optional ReLU (the zoo's conv3x3_bn_relu and friends)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1, groups: int = 1, act: bool = True):
        super().__init__()
        self.Conv_0, self.BatchNorm_0 = conv_bn(cin, cout, kernel, stride, dilation, groups)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.BatchNorm_0(self.Conv_0(x))
        return F.relu(x) if self.act else x


def adaptive_avg_pool(x: torch.Tensor, out: int) -> torch.Tensor:
    """Mean over torch's bin split [floor(i H / out), ceil((i + 1) H / out))
    of NCHW maps (the JAX package writes that split out by hand)."""
    return F.adaptive_avg_pool2d(x, out)


# --------------------------------------------------------------- ResNet(-X)


class BasicBlock(nn.Module):
    """resnet.py:24-53; the dilation pair is (conv1, conv2) after surgery."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dilation: Tuple[int, int] = (1, 1)):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(cin, planes, 3, stride, dilation[0])
        self.ConvBNAct_1 = ConvBNAct(planes, planes, 3, 1, dilation[1], act=False)
        self.ConvBNAct_2 = (ConvBNAct(cin, planes, 1, stride, act=False)
                            if stride != 1 or cin != planes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ConvBNAct_1(self.ConvBNAct_0(x))
        if self.ConvBNAct_2 is not None:
            x = self.ConvBNAct_2(x)
        return F.relu(x + y)


class Bottleneck(nn.Module):
    """resnet.py:56-93 (expansion 4) and resnext.py:23-60 (expansion 2,
    grouped 3x3) in one module; the dilation applies to the 3x3 conv."""

    def __init__(self, cin: int, planes: int, stride: int = 1, dilation: int = 1,
                 expansion: int = 4, groups: int = 1):
        super().__init__()
        out_ch = planes * expansion
        self.out_channels = out_ch
        self.ConvBNAct_0 = ConvBNAct(cin, planes, 1)
        self.ConvBNAct_1 = ConvBNAct(planes, planes, 3, stride, dilation, groups)
        self.ConvBNAct_2 = ConvBNAct(planes, out_ch, 1, act=False)
        self.ConvBNAct_3 = (ConvBNAct(cin, out_ch, 1, stride, act=False)
                            if stride != 1 or cin != out_ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ConvBNAct_2(self.ConvBNAct_1(self.ConvBNAct_0(x)))
        if self.ConvBNAct_3 is not None:
            x = self.ConvBNAct_3(x)
        return F.relu(x + y)


class ResNetEncoder(nn.Module):
    """Deep-stem ResNet/ResNeXt returning the four stage maps
    (models.py:190-291 Resnet/ResnetDilated over resnet.py/resnext.py).

    dilate_scale: 1 = plain (output stride 32); 8 = layer3 d2 + layer4 d4
    (output stride 8); 16 = layer4 d2."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2), block: str = "basic",
                 dilate_scale: int = 1, groups: int = 1, planes0: int = 64):
        super().__init__()
        # deep 3-conv stem (resnet.py:100-110): 3->64 s2, 64->64, 64->128
        self.ConvBNAct_0 = ConvBNAct(3, 64, 3, 2)
        self.ConvBNAct_1 = ConvBNAct(64, 64, 3, 1)
        self.ConvBNAct_2 = ConvBNAct(64, 128, 3, 1)
        dilate = {1: (1, 1), 16: (1, 2), 8: (2, 4)}[dilate_scale]
        kind = "BasicBlock" if block == "basic" else "Bottleneck"
        cin, k = 128, 0
        self.stages: List[List[str]] = []
        for stage in range(4):
            planes = planes0 * (2 ** stage)
            stride = 1 if stage == 0 else 2
            d = dilate[0] if stage == 2 else dilate[1] if stage == 3 else 1
            names = []
            for blk in range(layers[stage]):
                s = stride if blk == 0 else 1
                if d > 1 and blk == 0:
                    # _nostride_dilate: the stride-2 3x3 conv becomes
                    # stride 1 with dilation d/2 (models.py:258-271)
                    s, d_strided = 1, max(d // 2, 1)
                else:
                    d_strided = d
                if block == "basic":
                    mod = BasicBlock(cin, planes, s, (d_strided, d))
                    cin = planes
                else:
                    mod = Bottleneck(cin, planes, s, d_strided,
                                     2 if block == "group_bottleneck" else 4, groups)
                    cin = mod.out_channels
                names.append(f"{kind}_{k}")
                self.add_module(names[-1], mod)
                k += 1
            self.stages.append(names)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.ConvBNAct_2(self.ConvBNAct_1(self.ConvBNAct_0(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        out = []
        for names in self.stages:
            for n in names:
                x = getattr(self, n)(x)
            out.append(x)
        return out


# ------------------------------------------------------------------ HRNet


class HRModule(nn.Module):
    """HighResolutionModule (hrnet.py:105-250): BasicBlock chains per branch
    and the full cross-resolution fusion."""

    def __init__(self, num_channels: Sequence[int], num_blocks: int = 4):
        super().__init__()
        n = len(num_channels)
        self.n, self.num_blocks = n, num_blocks
        for i in range(n):
            for b in range(num_blocks):
                self.add_module(f"BasicBlock_{i * num_blocks + b}",
                                BasicBlock(num_channels[i], num_channels[i]))
        self.fuse = {}
        k = 0
        for i in range(n):
            for j in range(n):
                if j > i:
                    # 1x1 conv+BN, then a bilinear upsample (hrnet.py:186-194)
                    mods = [ConvBNAct(num_channels[j], num_channels[i], 1, act=False)]
                elif j < i:
                    # (i - j) strided 3x3 conv+BN, ReLU on all but the last
                    mods = []
                    for s in range(i - j):
                        last = s == i - j - 1
                        mods.append(ConvBNAct(num_channels[j],
                                              num_channels[i] if last else num_channels[j],
                                              3, 2, act=not last))
                else:
                    continue
                names = []
                for m in mods:
                    names.append(f"ConvBNAct_{k}")
                    self.add_module(names[-1], m)
                    k += 1
                self.fuse[(i, j)] = names

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        xs = list(xs)
        for i in range(self.n):
            for b in range(self.num_blocks):
                xs[i] = getattr(self, f"BasicBlock_{i * self.num_blocks + b}")(xs[i])
        fused = []
        for i in range(self.n):
            y = None
            for j in range(self.n):
                t = xs[j]
                for name in self.fuse.get((i, j), ()):
                    t = getattr(self, name)(t)
                if j > i:
                    t = resize(t, xs[i].shape[-2:])
                y = t if y is None else y + t
            fused.append(F.relu(y))
        return fused


class HRNetV2(nn.Module):
    """HRNetV2-W48 encoder (hrnet.py:259-442): stem /4, Bottleneck layer1,
    three multi-branch stages, the branches upsampled and concatenated ->
    one 720-channel stride-4 map (a one-element list, as the reference)."""

    def __init__(self, width: int = 48):
        super().__init__()
        w = width
        stage_channels = ([w, 2 * w], [w, 2 * w, 4 * w], [w, 2 * w, 4 * w, 8 * w])
        num_modules = (1, 4, 3)
        self.ConvBNAct_0 = ConvBNAct(3, 64, 3, 2)
        self.ConvBNAct_1 = ConvBNAct(64, 64, 3, 2)
        cin = 64
        for b in range(4):
            blk = Bottleneck(cin, 64, 1)
            self.add_module(f"Bottleneck_{b}", blk)
            cin = blk.out_channels
        # transitions (hrnet.py:311-345): a branch whose width already
        # matches is reused; a changed branch gets a 3x3 conv and a new one
        # a stride-2 3x3 conv, both fed the LAST previous branch
        chs, k, m = [cin], 2, 0
        self.plan = []
        for stage, chans in enumerate(stage_channels):
            trans = []
            for i, ch in enumerate(chans):
                if i < len(chs) and chs[i] == ch:
                    trans.append(None)
                    continue
                name = f"ConvBNAct_{k}"
                self.add_module(name, ConvBNAct(chs[-1], ch, 3, 1 if i < len(chs) else 2))
                trans.append(name)
                k += 1
            mods = []
            for _ in range(num_modules[stage]):
                mods.append(f"HRModule_{m}")
                self.add_module(mods[-1], HRModule(chans))
                m += 1
            self.plan.append((trans, mods))
            chs = list(chans)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.ConvBNAct_1(self.ConvBNAct_0(x))
        for b in range(4):
            x = getattr(self, f"Bottleneck_{b}")(x)
        xs = [x]
        for trans, mods in self.plan:
            xs = [xs[i] if name is None else getattr(self, name)(xs[-1])
                  for i, name in enumerate(trans)]
            for name in mods:
                xs = getattr(self, name)(xs)
        hw = xs[0].shape[-2:]
        return [torch.cat([xs[0]] + [resize(b, hw) for b in xs[1:]], dim=1)]


# ---------------------------------------------------------------- decoders


def _classes(x: torch.Tensor, regression_mode: bool) -> torch.Tensor:
    return x if regression_mode else F.log_softmax(x, dim=1)


def _default_channels(fc_dim: int) -> Tuple[int, ...]:
    return (fc_dim // 8, fc_dim // 4, fc_dim // 2, fc_dim)


class C1(nn.Module):
    """Plain last-conv decoder (models.py:385-414)."""

    def __init__(self, num_class: int = 1, fc_dim: int = 320, regression_mode: bool = True,
                 in_channels: Optional[Sequence[int]] = None):
        super().__init__()
        cin = (in_channels or _default_channels(fc_dim))[-1]
        self.ConvBNAct_0 = ConvBNAct(cin, fc_dim // 4, 3)
        self.conv_last = nn.Conv2d(fc_dim // 4, num_class, 1)
        self.regression_mode = regression_mode

    def forward(self, conv_out):
        return _classes(self.conv_last(self.ConvBNAct_0(conv_out[-1])), self.regression_mode)


class PPMCore(nn.Module):
    """Pyramid pooling over conv5 (models.py:426-457): pool to 1/2/3/6, 1x1
    conv to 512, upsample, concatenate with conv5."""

    def __init__(self, cin: int, pool_scales: Sequence[int] = POOL_SCALES):
        super().__init__()
        self.pool_scales = tuple(pool_scales)
        for k in range(len(self.pool_scales)):
            self.add_module(f"ConvBNAct_{k}", ConvBNAct(cin, PPM_DIM, 1))

    def forward(self, conv5: torch.Tensor) -> torch.Tensor:
        hw = conv5.shape[-2:]
        outs = [conv5]
        for k, s in enumerate(self.pool_scales):
            p = getattr(self, f"ConvBNAct_{k}")(adaptive_avg_pool(conv5, s))
            outs.append(resize(p, hw))
        return torch.cat(outs, dim=1)


class PPM(nn.Module):
    """models.py:417-467 (channel dropout 0.1 before the class conv); with
    deep_sup PPMDeepsup (models.py:470-533), whose deep-supervision branch
    draws a channel dropout of its own through the same module."""

    def __init__(self, num_class: int = 1, fc_dim: int = 2048, regression_mode: bool = True,
                 deep_sup: bool = False, in_channels: Optional[Sequence[int]] = None):
        super().__init__()
        chans = in_channels or _default_channels(fc_dim)
        self.PPMCore_0 = PPMCore(chans[-1])
        self.ConvBNAct_0 = ConvBNAct(chans[-1] + len(POOL_SCALES) * PPM_DIM, PPM_DIM, 3)
        self.dropout = nn.Dropout2d(0.1)
        self.conv_last = nn.Conv2d(PPM_DIM, num_class, 1)
        self.regression_mode, self.deep_sup = regression_mode, deep_sup
        if deep_sup:
            self.ConvBNAct_1 = ConvBNAct(chans[-2], fc_dim // 4, 3)
            self.conv_last_deepsup = nn.Conv2d(fc_dim // 4, num_class, 1)

    def forward(self, conv_out):
        x = self.ConvBNAct_0(self.PPMCore_0(conv_out[-1]))
        x = _classes(self.conv_last(self.dropout(x)), self.regression_mode)
        if not (self.training and self.deep_sup):
            return x
        y = self.dropout(self.ConvBNAct_1(conv_out[-2]))
        return x, _classes(self.conv_last_deepsup(y), self.regression_mode)


class UPerNet(nn.Module):
    """PPM head on conv5 and FPN top-down fusion over every stage map
    (models.py:536-627); fpn_dim 512 = 'upernet', 256 = 'upernet_lite'. The
    lateral widths are the encoder's (the reference hard-codes ResNet's)."""

    def __init__(self, num_class: int = 1, fpn_dim: int = 256, regression_mode: bool = True,
                 fc_dim: int = 2048, in_channels: Optional[Sequence[int]] = None):
        super().__init__()
        chans = tuple(in_channels or _default_channels(fc_dim))
        self.fpn_dim, self.n = fpn_dim, len(chans)
        self.regression_mode = regression_mode
        self.PPMCore_0 = PPMCore(chans[-1])
        self.ConvBNAct_0 = ConvBNAct(chans[-1] + len(POOL_SCALES) * PPM_DIM, fpn_dim, 3)
        k = 1
        self.levels = []
        for i in reversed(range(self.n - 1)):
            self.add_module(f"ConvBNAct_{k}", ConvBNAct(chans[i], fpn_dim, 1))
            self.add_module(f"ConvBNAct_{k + 1}", ConvBNAct(fpn_dim, fpn_dim, 3))
            self.levels.append((i, f"ConvBNAct_{k}", f"ConvBNAct_{k + 1}"))
            k += 2
        self.fuse_name = f"ConvBNAct_{k}"
        self.add_module(self.fuse_name, ConvBNAct(self.n * fpn_dim, fpn_dim, 3))
        self.conv_last = nn.Conv2d(fpn_dim, num_class, 1)

    def forward(self, conv_out):
        f = self.ConvBNAct_0(self.PPMCore_0(conv_out[-1]))
        fpn = [f]
        for i, lateral, out in self.levels:
            lat = getattr(self, lateral)(conv_out[i])
            f = lat + resize(f, lat.shape[-2:])
            fpn.append(getattr(self, out)(f))
        fpn.reverse()
        hw = fpn[0].shape[-2:]
        fused = torch.cat([fpn[0]] + [resize(m, hw) for m in fpn[1:]], dim=1)
        x = self.conv_last(getattr(self, self.fuse_name)(fused))
        return _classes(x, self.regression_mode)


# ----------------------------------------------------------------- builder


def build_encoder(arch: str = "mobilenetv2dilated") -> nn.Module:
    """ModelBuilder.build_encoder (models.py:78-124)."""
    arch = arch.lower()
    if arch == "mobilenetv2dilated":
        from .mobilenet import MobileNetV2Dilated

        return MobileNetV2Dilated()
    scale = 8 if arch.endswith("dilated") else 1
    if arch in ("resnet18", "resnet18dilated"):
        return ResNetEncoder((2, 2, 2, 2), "basic", scale)
    if arch in ("resnet50", "resnet50dilated"):
        return ResNetEncoder((3, 4, 6, 3), "bottleneck", scale)
    if arch in ("resnet101", "resnet101dilated"):
        return ResNetEncoder((3, 4, 23, 3), "bottleneck", scale)
    if arch == "resnext101":
        return ResNetEncoder((3, 4, 23, 3), "group_bottleneck", groups=32, planes0=128)
    if arch == "hrnetv2":
        return HRNetV2()
    raise ValueError(f"Architecture undefined: {arch!r}")


def build_decoder(arch: str = "c1_deepsup", fc_dim: int = 320, num_class: int = 1,
                  regression_mode: bool = True,
                  in_channels: Optional[Sequence[int]] = None) -> nn.Module:
    """ModelBuilder.build_decoder (models.py:126-177). `in_channels`: the
    widths of the encoder's maps (default: fc_dim / 8, / 4, / 2, / 1, a
    ResNet's)."""
    arch = arch.lower()
    kw = dict(num_class=num_class, regression_mode=regression_mode, in_channels=in_channels)
    if arch == "c1_deepsup":
        from .introspection import C1DeepSup

        return C1DeepSup(num_class=num_class, fc_dim=fc_dim)
    if arch == "c1":
        return C1(fc_dim=fc_dim, **kw)
    if arch in ("ppm", "ppm_deepsup"):
        return PPM(fc_dim=fc_dim, deep_sup=arch == "ppm_deepsup", **kw)
    if arch in ("upernet", "upernet_lite"):
        return UPerNet(fpn_dim=512 if arch == "upernet" else 256, fc_dim=fc_dim, **kw)
    raise ValueError(f"Architecture undefined: {arch!r}")


class SegmentationModel(nn.Module):
    """Encoder + decoder pair built by arch name, the zoo counterpart of
    SegmentationModule (models.py:23-61); the loss lives in train/losses.py.
    Built in eval mode."""

    def __init__(self, arch_encoder: str = "mobilenetv2dilated",
                 arch_decoder: str = "c1_deepsup", fc_dim: int = 0, num_class: int = 1,
                 regression_mode: bool = True):
        super().__init__()
        fc_dim = fc_dim or ENCODER_FC_DIM[arch_encoder.lower()]
        self.encoder = build_encoder(arch_encoder)
        self.decoder = build_decoder(arch_decoder, fc_dim, num_class, regression_mode,
                                     encoder_channels(arch_encoder))
        self.eval()

    def forward(self, x: torch.Tensor):
        with span("fcn.encoder"):
            conv_out = self.encoder(x)
        with span("fcn.decoder"):
            return self.decoder(conv_out)
