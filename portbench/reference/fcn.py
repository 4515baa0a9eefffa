"""The introspection FCN in plain PyTorch: MobileNetV2 with output stride 8
by dilation (networks/models/models.py:291-345) and the C1-DeepSup head in
regression mode (models.py:347-384), its uint8 cost map
(models_light.py:18-28, stereo_kitti.cc:492-517), and the training recipe
of training/train_modular.py: masked MSE plus 0.4x deep supervision, SGD
with momentum 0.9, weight decay 1e-4 on kernels only (group_weight), poly
learning-rate decay with power 0.9.

Parameters live in a flat dict under the upstream names
(``encoder.features.N.conv.M.weight``, ``decoder.cbr.0.weight``, ...), so
one set of seeded tensors feeds both this reference and the system under
test. BatchNorm in training normalises with the biased batch variance
E[x^2] - E[x]^2 and keeps 0.9 old + 0.1 new (flax's BatchNorm, which the
JAX trainer used); in eval it uses the running statistics.

``precision`` is "fp32" (float32 without TF32: the precision the
configurations state) or "tf32": the convolution operands rounded to TF32's
10-bit mantissa. On the card "tf32" runs cuDNN with TF32 allowed; on the
CPU the operands and the incoming gradients are rounded explicitly.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-5
BN_MOMENTUM = 0.9


# --- architecture --------------------------------------------------------

def conv_plan(arch: dict) -> List[dict]:
    """Every convolution of the network in execution order: name (its
    weight's key without ``.weight``), cin, cout, kernel, stride, dilation,
    groups, whether a BatchNorm follows (key ``bn``), the activation after
    it, whether it has a bias, and ``block``: the encoder stage it belongs
    to (0 the stem, 1-17 the inverted residuals, "head" or "deepsup")."""
    plan = []

    def conv(name, cin, cout, k, stride=1, dil=1, groups=1, bn=None, act=None, bias=False,
             block=None):
        plan.append(dict(name=name, cin=cin, cout=cout, k=k, stride=stride, dil=dil,
                         groups=groups, bn=bn, act=act, bias=bias, block=block))

    c0 = arch["stem_channels"]
    conv("encoder.features.0.0", 3, c0, 3, stride=2, bn="encoder.features.0.1",
         act="relu6", block=0)
    d2, d4 = arch["dilate_from"]
    cin, idx = c0, 1
    for t, c, n, s in arch["inverted_residual_setting"]:
        for i in range(n):
            stride = s if i == 0 else 1
            if idx >= d4:           # output stride 8: dilation 4 region
                dil, stride = (2, 1) if stride == 2 else (4, stride)
            elif idx >= d2:         # dilation 2 region
                dil, stride = (1, 1) if stride == 2 else (2, stride)
            else:
                dil = 1
            hid = cin * t
            p = f"encoder.features.{idx}.conv"
            j = 0
            if t != 1:
                conv(f"{p}.{j}", cin, hid, 1, bn=f"{p}.{j + 1}", act="relu6", block=idx)
                j += 3
            conv(f"{p}.{j}", hid, hid, 3, stride, dil, groups=hid, bn=f"{p}.{j + 1}",
                 act="relu6", block=idx)
            j += 3
            conv(f"{p}.{j}", hid, c, 1, bn=f"{p}.{j + 1}", act=None, block=idx)
            cin, idx = c, idx + 1
    fc = arch["fc_dim"]
    conv("decoder.cbr.0", fc, fc // 4, 3, bn="decoder.cbr.1", act="relu", block="head")
    conv("decoder.conv_last", fc // 4, arch["num_class"], 1, bias=True, block="head")
    conv("decoder.cbr_deepsup.0", fc // 2, fc // 4, 3, bn="decoder.cbr_deepsup.1", act="relu",
         block="deepsup")
    conv("decoder.conv_last_deepsup", fc // 4, arch["num_class"], 1, bias=True,
         block="deepsup")
    return plan


def residual_blocks(arch: dict) -> Dict[int, bool]:
    """Inverted residual idx -> whether it adds its input (stride 1, width kept)."""
    out, cin, idx = {}, arch["stem_channels"], 1
    for t, c, n, s in arch["inverted_residual_setting"]:
        for i in range(n):
            out[idx] = (s if i == 0 else 1) == 1 and cin == c
            cin, idx = c, idx + 1
    return out


def param_shapes(arch: dict) -> Dict[str, Tuple[int, ...]]:
    """Key -> shape of every parameter and BatchNorm buffer."""
    shapes = {}
    for c in conv_plan(arch):
        shapes[c["name"] + ".weight"] = (c["cout"], c["cin"] // c["groups"], c["k"], c["k"])
        if c["bias"]:
            shapes[c["name"] + ".bias"] = (c["cout"],)
        if c["bn"]:
            for f in ("weight", "bias", "running_mean", "running_var"):
                shapes[f"{c['bn']}.{f}"] = (c["cout"],)
    return shapes


def is_buffer(key: str) -> bool:
    return key.endswith(".running_mean") or key.endswith(".running_var")


# --- numerics ------------------------------------------------------------

def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with a 10-bit mantissa (ties away)."""
    b = t.contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)


class _TF32(torch.autograd.Function):
    """Rounds the value forward and the gradient backward."""

    @staticmethod
    def forward(ctx, x):
        return _round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return _round_tf32(g)


class _TF32Grad(torch.autograd.Function):
    """Identity forward; rounds the gradient backward."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return _round_tf32(g)


def numerics(device: torch.device, precision: str):
    """The cuDNN flags a precision runs under on the card."""
    if precision not in ("fp32", "tf32"):
        raise ValueError(f"precision {precision!r}")
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                      allow_tf32=precision == "tf32")


def _conv(x, w, b, c, emulate_tf32: bool):
    if emulate_tf32:
        x, w = _TF32.apply(x), _TF32.apply(w)
    y = F.conv2d(x, w, b, c["stride"], c["dil"] * (c["k"] // 2), c["dil"], c["groups"])
    return _TF32Grad.apply(y) if emulate_tf32 else y


def _batch_norm(x, p, name, train: bool, stats: Dict[str, torch.Tensor]):
    w, b = p[name + ".weight"], p[name + ".bias"]
    rm, rv = stats[name + ".running_mean"], stats[name + ".running_var"]
    if not train:
        mul = torch.rsqrt(rv + BN_EPS) * w
        return (x - rm.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)
    mean = x.mean((0, 2, 3))
    var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
    with torch.no_grad():
        stats[name + ".running_mean"] = BN_MOMENTUM * rm + (1.0 - BN_MOMENTUM) * mean
        stats[name + ".running_var"] = BN_MOMENTUM * rv + (1.0 - BN_MOMENTUM) * var
    mul = torch.rsqrt(var + BN_EPS) * w
    return (x - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)


def forward(arch: dict, p: Dict[str, torch.Tensor], x: torch.Tensor, train: bool,
            stats: Dict[str, torch.Tensor], precision: str = "fp32"):
    """(B, 3, H, W) normalised image -> the (B, 1, H/8, W/8) prediction; in
    training also the deep-supervision prediction, and ``stats`` updated in
    place (its tensors replaced)."""
    emulate = precision == "tf32" and x.device.type != "cuda"
    plan = conv_plan(arch)

    def cbn(y, c):
        y = _batch_norm(_conv(y, p[c["name"] + ".weight"], None, c, emulate), p, c["bn"],
                        train, stats)
        return torch.clamp(y, 0.0, 6.0) if c["act"] == "relu6" else y

    x = cbn(x, plan[0])
    tap = None
    for idx, has_res in residual_blocks(arch).items():
        y = x
        for c in plan:
            if c["block"] == idx:
                y = cbn(y, c)
        x = x + y if has_res else y
        if idx == arch["dilate_from"][1]:
            tap = x
    head = [c for c in plan if c["block"] in ("head", "deepsup")]

    def branch(feat, convs):
        cbr, last = convs
        y = _conv(feat, p[cbr["name"] + ".weight"], None, cbr, emulate)
        y = torch.relu(_batch_norm(y, p, cbr["bn"], train, stats))
        return _conv(y, p[last["name"] + ".weight"], p[last["name"] + ".bias"], last, emulate)

    pred = branch(x, [c for c in head if c["block"] == "head"])
    if not train:
        return pred
    return pred, branch(tap, [c for c in head if c["block"] == "deepsup"])


# --- inference: the uint8 cost map ---------------------------------------

def normalize(img_u8: torch.Tensor) -> torch.Tensor:
    """uint8 RGB (..., H, W, 3) -> ImageNet-normalised float32, each division
    by a constant a product with its float32 reciprocal."""
    x = img_u8.to(torch.float32) * float(np.float32(1.0 / 255.0))
    mean = [float(v) for v in np.float32(IMAGENET_MEAN)]
    inv = [float(v) for v in np.float32(1.0) / np.float32(IMAGENET_STD)]
    return torch.stack([(x[..., c] - mean[c]) * inv[c] for c in range(3)], dim=-1)


def resize(x: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear with half-pixel centres, widened by the scale when
    shrinking (jax.image.resize's antialiasing)."""
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False,
                         antialias=True)


@torch.no_grad()
def predict(arch, p, stats, img_u8: torch.Tensor, net_hw, precision="fp32") -> torch.Tensor:
    """uint8 RGB (B, H, W, 3) -> (B, 1, h/8, w/8) prediction at net_hw."""
    x = resize(normalize(img_u8).permute(0, 3, 1, 2).contiguous(), net_hw)
    with numerics(x.device, precision):
        return forward(arch, p, x, False, stats, precision)


@torch.no_grad()
def cost_map(arch, p, stats, img_u8: torch.Tensor, out_hw, net_hw,
             precision="fp32") -> torch.Tensor:
    """uint8 RGB (B, H, W, 3) -> (B, H', W') uint8 cost map at out_hw:
    sigmoid(20 (x - 0.5)) of the resized prediction, times 255, clipped
    and truncated."""
    pred = resize(predict(arch, p, stats, img_u8, net_hw, precision), out_hw)
    pred = torch.sigmoid(20.0 * (pred - 0.5))
    return torch.clamp(pred[:, 0] * 255.0, 0, 255).to(torch.uint8)


# --- training ------------------------------------------------------------

def masked_mse(pred, target, mask):
    return ((pred - target) ** 2 * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def poly_lr(base: float, step: int, max_iters: int, power: float) -> float:
    frac = min(max(step / max_iters, 0.0), 1.0)
    return base * (1.0 - frac) ** power


def train_steps(arch: dict, recipe: dict, params: Dict[str, torch.Tensor],
                batches, precision: str = "fp32", rows=None) -> dict:
    """len(batches) SGD steps of the recipe from ``params`` (weights and
    BatchNorm statistics under their keys; not modified). Each batch is
    (image NCHW normalised, target, mask) on the device. ``rows`` limits
    every batch to those rows (a fault the checks must catch).

    Returns ``loss`` (each step's, float), ``grad`` (step 1's raw gradient
    by key), ``update`` (step 1's gradient as SGD gets it: plus weight decay
    on kernels), and ``params`` after the last step, statistics included."""
    p = {k: v.detach().clone() for k, v in params.items() if not is_buffer(k)}
    stats = {k: v.detach().clone() for k, v in params.items() if is_buffer(k)}
    for v in p.values():
        v.requires_grad_(True)
    keys = list(p)
    mom: Dict[str, torch.Tensor] = {}
    out = dict(loss=[], grad=None, update=None)
    for step, (image, target, mask) in enumerate(batches):
        if rows is not None:
            image, target, mask = image[rows], target[rows], mask[rows]
        with numerics(image.device, precision):
            pred, pred_ds = forward(arch, p, image, True, stats, precision)
            loss = masked_mse(pred, target, mask) + recipe["deep_sup_scale"] * masked_mse(
                pred_ds, target, mask)
            grads = torch.autograd.grad(loss, [p[k] for k in keys])
        lr = poly_lr(recipe["lr"], step, recipe["num_epochs"] * 1000, recipe["lr_pow"])
        upd = {}
        with torch.no_grad():
            for k, g in zip(keys, grads):
                d = g + recipe["weight_decay"] * p[k] if p[k].ndim >= 2 else g
                mom[k] = d.clone() if step == 0 else recipe["momentum"] * mom[k] + d
                p[k] -= lr * mom[k]
                upd[k] = d
        out["loss"].append(float(loss.detach()))
        if step == 0:
            out["grad"] = {k: g.detach() for k, g in zip(keys, grads)}
            out["update"] = upd
    out["params"] = {**{k: v.detach() for k, v in p.items()}, **stats}
    return out
