"""Image traffic made on the device from the seed, in a few large calls:
the FCN training pool (normalised images, heatmap targets and masks, as the
training reader hands them over) and a ring of colour camera frames."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import seeds

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _smooth(g: torch.Generator, n: int, c: int, hw, cell: int, device) -> torch.Tensor:
    """(n, c, h, w) float32 noise, smooth at `cell` px, about unit variance."""
    h, w = hw
    lo = torch.randn((n, c, -(-h // cell) + 1, -(-w // cell) + 1), generator=g,
                     device=device)
    return F.interpolate(lo, size=(h, w), mode="bicubic", align_corners=False)


def _texture(g, n, hw, device) -> torch.Tensor:
    """(n, 3, h, w) uint8-valued float32 colour texture: smooth regions
    with fine grain on top."""
    x = 0.6 * _smooth(g, n, 3, hw, 32, device) + 0.3 * _smooth(g, n, 3, hw, 6, device)
    x = x + 0.1 * torch.randn(x.shape, generator=g, device=device)
    return torch.clamp(128.0 + 60.0 * x, 0.0, 255.0).round()


def fcn_pool(seed: int, n: int, hw, device, stride: int = 8) -> dict:
    """The training pool: ``image`` (n, H, W, 3) ImageNet-normalised
    float32, ``target`` (n, H/stride, W/stride, 1) heatmaps in [0, 1] and
    ``mask`` (same shape) of 0 and 1, about 70% ones."""
    g = torch.Generator(device=device).manual_seed(seeds.child(seed, 101))
    img = _texture(g, n, hw, device) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=device).view(1, 3, 1, 1)
    image = ((img - mean) / std).permute(0, 2, 3, 1).contiguous()
    th = (hw[0] // stride, hw[1] // stride)
    target = torch.sigmoid(2.5 * _smooth(g, n, 1, th, 8, device)).permute(0, 2, 3, 1)
    mask = (_smooth(g, n, 1, th, 4, device) > -0.5).to(torch.float32).permute(0, 2, 3, 1)
    return dict(image=image, target=target.contiguous(), mask=mask.contiguous())


def colour_ring(seed: int, n: int, hw, device) -> torch.Tensor:
    """(n, H, W, 3) uint8 colour frames."""
    g = torch.Generator(device=device).manual_seed(seeds.child(seed, 102))
    return _texture(g, n, hw, device).to(torch.uint8).permute(0, 2, 3, 1).contiguous()
