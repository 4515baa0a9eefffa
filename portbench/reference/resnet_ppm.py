"""PSPNet-101 in plain PyTorch: the deep-stem ResNet-101 with dilation 2 and
4 in its last two stages (output stride 8) and the PPM-DeepSup head in
regression mode, as CSAILVision/semantic-segmentation-pytorch builds it
(config/ade20k-resnet101dilated-ppm_deepsup.yaml: ModelBuilder's
``resnet101dilated`` encoder and ``ppm_deepsup`` decoder, fc_dim 2048), the
upstream of IV-SLAM's introspection_function/networks; trained with
IV-SLAM's recipe (training/train_modular.py in regression mode): masked
MSE plus 0.4x deep supervision, SGD with momentum, weight decay on kernels
only, poly learning-rate decay.

The network (models.py ResnetDilated over resnet.py, and PPMDeepsup):
  stem      conv1 3x3/2 3->64, conv2 3x3 64->64, conv3 3x3 64->128, each
            BatchNorm + ReLU, then a 3x3/2 max pool
  layer1-4  Bottlenecks (1x1, 3x3, 1x1 with expansion 4; BatchNorm after
            each; ReLU after the first two and after the residual sum; a
            1x1 + BatchNorm downsample on the first block), depths
            ``layers`` ([3, 4, 23, 3]), widths 64/128/256/512 x 4;
            ``_nostride_dilate``: in layer3 the stride-2 3x3 becomes stride
            1, dilation 1, the rest dilation 2; in layer4 dilation 2 and 4;
            the downsamples lose their stride
  ppm       on conv5 (layer4): adaptive average pools to 1, 2, 3, 6, each a
            1x1 conv to 512 + BatchNorm + ReLU, upsampled bilinearly to
            conv5's size and concatenated with it (4,096 channels)
  conv_last 3x3 conv 4096->512 + BatchNorm + ReLU, Dropout2d(0.1), 1x1
            conv to num_class with a bias
  deepsup   on conv4 (layer3): 3x3 conv 1024->512 + BatchNorm + ReLU
            (cbr_deepsup), Dropout2d(0.1), 1x1 conv with a bias

Parameters live in a flat dict under the upstream names
(``encoder.layer3.7.conv2.weight``, ``decoder.ppm.2.1.weight``,
``decoder.conv_last.4.bias``, ...).

Departures from upstream, each shared with the system under test:
  * BatchNorm keeps flax's statistics (reference/fcn.py): the biased batch
    variance E[x^2] - E[x]^2, running 0.9 old + 0.1 new; upstream's
    synchronized BatchNorm stores the unbiased variance;
  * regression mode: one class, no log-softmax, and the loss is IV-SLAM's
    masked MSE, not upstream's NLL;
  * the two dropouts do not draw: ``masks`` gives each its keep mask (the
    system's own, so that both sides drop the same channels), applied as
    x * mask / (1 - p);
  * weights come from the seed, not the ImageNet snapshot.

``precision`` as in reference/fcn.py: "fp32" (float32 without TF32) or
"tf32", the nearest precision below it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .fcn import _batch_norm, _conv, is_buffer, masked_mse, numerics, poly_lr

EXPANSION = 4


# --- architecture --------------------------------------------------------

def conv_plan(arch: dict) -> List[dict]:
    """Every convolution of the training network in execution order: name
    (its weight's key without ``.weight``), cin, cout, kernel, stride,
    dilation, groups (1), the BatchNorm after it (``bn``), the activation,
    whether it has a bias, ``block`` ("stem", (stage, index), "ppm",
    "head" or "deepsup") and ``grid``: the size of its output, "s2", "s4"
    or "s8" for the input's size over 2, 4 or 8 (each halving as a 3x3/2
    convolution's), or the pooled scale (an int)."""
    plan = []

    def conv(name, cin, cout, k, stride=1, dil=1, bn=None, act=None, bias=False, block=None,
             grid=None):
        plan.append(dict(name=name, cin=cin, cout=cout, k=k, stride=stride, dil=dil, groups=1,
                         bn=bn, act=act, bias=bias, block=block, grid=grid))

    s1, s2, s3 = arch["stem_channels"]
    conv("encoder.conv1", 3, s1, 3, 2, bn="encoder.bn1", act="relu", block="stem", grid="s2")
    conv("encoder.conv2", s1, s2, 3, bn="encoder.bn2", act="relu", block="stem", grid="s2")
    conv("encoder.conv3", s2, s3, 3, bn="encoder.bn3", act="relu", block="stem", grid="s2")
    d3, d4 = arch["dilation"]
    cin, grid = s3, "s4"
    for stage, depth in enumerate(arch["layers"]):
        planes = 64 * 2 ** stage
        dil = (1, 1, d3, d4)[stage]
        for b in range(depth):
            p = f"encoder.layer{stage + 1}.{b}"
            stride = 2 if b == 0 and stage == 1 else 1     # layer3/4 lose theirs
            if b == 0 and stage == 1:
                grid = "s8"
            d = max(dil // 2, 1) if b == 0 else dil
            blk = (stage, b)
            conv(f"{p}.conv1", cin, planes, 1, bn=f"{p}.bn1", act="relu", block=blk,
                 grid="s4" if stride == 2 else grid)
            conv(f"{p}.conv2", planes, planes, 3, stride, d, bn=f"{p}.bn2", act="relu",
                 block=blk, grid=grid)
            conv(f"{p}.conv3", planes, planes * EXPANSION, 1, bn=f"{p}.bn3", block=blk,
                 grid=grid)
            if b == 0:
                conv(f"{p}.downsample.0", cin, planes * EXPANSION, 1, stride,
                     bn=f"{p}.downsample.1", block=blk, grid=grid)
            cin = planes * EXPANSION
    fc, dim = arch["fc_dim"], arch["ppm_dim"]
    for i, s in enumerate(arch["pool_scales"]):
        conv(f"decoder.ppm.{i}.1", fc, dim, 1, bn=f"decoder.ppm.{i}.2", act="relu",
             block="ppm", grid=s)
    conv("decoder.conv_last.0", fc + len(arch["pool_scales"]) * dim, dim, 3,
         bn="decoder.conv_last.1", act="relu", block="head", grid="s8")
    conv("decoder.conv_last.4", dim, arch["num_class"], 1, bias=True, block="head", grid="s8")
    conv("decoder.cbr_deepsup.0", fc // 2, fc // 4, 3, bn="decoder.cbr_deepsup.1", act="relu",
         block="deepsup", grid="s8")
    conv("decoder.conv_last_deepsup", fc // 4, arch["num_class"], 1, bias=True,
         block="deepsup", grid="s8")
    return plan


def param_shapes(arch: dict) -> Dict[str, Tuple[int, ...]]:
    """Key -> shape of every parameter and BatchNorm buffer."""
    shapes = {}
    for c in conv_plan(arch):
        shapes[c["name"] + ".weight"] = (c["cout"], c["cin"], c["k"], c["k"])
        if c["bias"]:
            shapes[c["name"] + ".bias"] = (c["cout"],)
        if c["bn"]:
            for f in ("weight", "bias", "running_mean", "running_var"):
                shapes[f"{c['bn']}.{f}"] = (c["cout"],)
    return shapes


# --- forward -------------------------------------------------------------

def _upsample(x: torch.Tensor, hw) -> torch.Tensor:
    """Upstream's F.interpolate(..., mode="bilinear", align_corners=False)."""
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False)


def forward(arch: dict, p: Dict[str, torch.Tensor], x: torch.Tensor, train: bool,
            stats: Dict[str, torch.Tensor], precision: str = "fp32", masks=None):
    """(B, 3, H, W) normalised image -> the (B, 1, H/8, W/8) prediction; in
    training also the deep-supervision prediction, ``stats`` updated in
    place (its tensors replaced), and ``masks`` the keep masks of the main
    head's and the deep-supervision branch's dropout, in that order, each
    broadcastable to the map it drops."""
    emulate = precision == "tf32" and x.device.type != "cuda"
    convs = {c["name"]: c for c in conv_plan(arch)}
    keep = 1.0 - arch["dropout"]

    def cbn(y, name):
        c = convs[name]
        y = _conv(y, p[name + ".weight"], p.get(name + ".bias"), c, emulate)
        if c["bn"]:
            y = _batch_norm(y, p, c["bn"], train, stats)
        return torch.relu(y) if c["act"] == "relu" else y

    def drop(y, i):
        if not train:
            return y
        if masks is None:
            raise ValueError("training needs the dropouts' keep masks")
        return y * masks[i].to(y.dtype) / keep

    x = cbn(cbn(cbn(x, "encoder.conv1"), "encoder.conv2"), "encoder.conv3")
    x = F.max_pool2d(x, 3, 2, 1)
    taps = []
    for stage, depth in enumerate(arch["layers"]):
        for b in range(depth):
            q = f"encoder.layer{stage + 1}.{b}"
            y = cbn(cbn(cbn(x, q + ".conv1"), q + ".conv2"), q + ".conv3")
            if b == 0:
                x = cbn(x, q + ".downsample.0")
            x = torch.relu(x + y)
        taps.append(x)
    conv4, conv5 = taps[2], taps[3]
    hw = conv5.shape[-2:]
    pyramid = [conv5] + [
        _upsample(cbn(F.adaptive_avg_pool2d(conv5, s), f"decoder.ppm.{i}.1"), hw)
        for i, s in enumerate(arch["pool_scales"])]
    y = cbn(torch.cat(pyramid, 1), "decoder.conv_last.0")
    pred = cbn(drop(y, 0), "decoder.conv_last.4")
    if not train:
        return pred
    y = cbn(conv4, "decoder.cbr_deepsup.0")
    return pred, cbn(drop(y, 1), "decoder.conv_last_deepsup")


# --- training ------------------------------------------------------------

def train_steps(arch: dict, recipe: dict, params: Dict[str, torch.Tensor], batches,
                masks, precision: str = "fp32", deep_sup: bool = True) -> dict:
    """len(batches) SGD steps of the recipe from ``params`` (weights and
    BatchNorm statistics under their keys; not modified), as
    reference/fcn.py's ``train_steps``, the decoder's parameters at the
    recipe's ``lr_decoder`` where it has one; ``masks[i]`` are step i's two keep
    masks (``forward``). ``deep_sup`` False leaves the deep-supervision term
    out of the loss (a fault the checks must catch).

    Returns ``loss`` (each step's, float), ``grad`` (step 1's raw gradient
    by key), ``update`` (step 1's gradient as SGD gets it: plus weight decay
    on kernels), ``step1`` and ``params``: the weights and statistics after
    step 1 and after the last step."""
    p = {k: v.detach().clone() for k, v in params.items() if not is_buffer(k)}
    stats = {k: v.detach().clone() for k, v in params.items() if is_buffer(k)}
    for v in p.values():
        v.requires_grad_(True)
    keys = list(p)
    mom: Dict[str, torch.Tensor] = {}
    out = dict(loss=[], grad=None, update=None)
    scale = recipe["deep_sup_scale"] if deep_sup else 0.0
    base = {k: recipe.get("lr_decoder", recipe["lr"]) if k.startswith("decoder.") else
            recipe["lr"] for k in keys}
    for step, (image, target, mask) in enumerate(batches):
        with numerics(image.device, precision):
            pred, pred_ds = forward(arch, p, image, True, stats, precision, masks[step])
            loss = masked_mse(pred, target, mask) + scale * masked_mse(pred_ds, target, mask)
            grads = torch.autograd.grad(loss, [p[k] for k in keys])
        upd = {}
        with torch.no_grad():
            for k, g in zip(keys, grads):
                d = g + recipe["weight_decay"] * p[k] if p[k].ndim >= 2 else g
                mom[k] = d.clone() if step == 0 else recipe["momentum"] * mom[k] + d
                p[k] -= poly_lr(base[k], step, recipe["num_epochs"] * 1000,
                                recipe["lr_pow"]) * mom[k]
                upd[k] = d
        out["loss"].append(float(loss.detach()))
        if step == 0:
            out["grad"] = {k: g.detach() for k, g in zip(keys, grads)}
            out["update"] = upd
            out["step1"] = {**{k: v.detach().clone() for k, v in p.items()}, **stats}
        del grads, loss, pred, pred_ds
    out["params"] = {**{k: v.detach() for k, v in p.items()}, **stats}
    return out
