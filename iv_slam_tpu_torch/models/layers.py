"""Layers the port's networks share: a BatchNorm with flax's training
statistics, flax's default initialisation, and the bilinear resize of
``jax.image.resize``.

BatchNorm. The JAX package's networks use ``flax.linen.BatchNorm(momentum=
0.9, epsilon=1e-5)``. In training mode it normalises with the *biased*
variance, computed as E[x^2] - E[x]^2 (clipped at 0), and stores
``0.9 old + 0.1 batch`` of that same variance. ``nn.BatchNorm2d`` stores the
unbiased variance instead (n / (n - 1) larger: 1.008 at 8x8 maps and batch
2), and ``nn.SyncBatchNorm`` has the same convention and refuses CPU
tensors once a process group exists. ``BatchNorm2d`` below subclasses
``nn.BatchNorm2d`` (so the upstream names ``weight``/``bias``/
``running_mean``/``running_var`` stay) and computes flax's statistics; in
eval mode it is ``nn.BatchNorm2d`` unchanged. Given a process group
(``set_process_group``), it averages the per-rank means of x and x^2
through the differentiable all-reduce, which is what flax's ``axis_name``
pmean computes: statistics of the global batch. That all-reduce records
the span ``bn.allreduce`` (``utils.profiling.span``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import span

MOMENTUM = 0.9
# truncated_normal's standard deviation on [-2, 2] (jax.nn.initializers)
_TRUNC_STD = 0.87962566103423978


class BatchNorm2d(nn.BatchNorm2d):
    """flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5) on NCHW."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps)
        self.process_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        axes = (0, 2, 3)
        stats = torch.stack([x.mean(axes), (x * x).mean(axes)])
        if self.process_group is not None:
            import torch.distributed as dist
            from torch.distributed.nn.functional import all_reduce

            with span("bn.allreduce"):
                stats = all_reduce(stats, group=self.process_group) / dist.get_world_size(
                    self.process_group)
        mean, mean2 = stats[0], stats[1]
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.copy_(MOMENTUM * self.running_mean + (1.0 - MOMENTUM) * mean)
            self.running_var.copy_(MOMENTUM * self.running_var + (1.0 - MOMENTUM) * var)
            self.num_batches_tracked.add_(1)
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


def set_process_group(model: nn.Module, group) -> None:
    """Average every ``BatchNorm2d``'s training statistics over `group`
    (None: this process's batch only)."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.process_group = group


def flax_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's default initialisation, drawn from `generator` in module
    order: convolution kernels ``lecun_normal`` (a normal truncated to 2
    standard deviations, variance 1 / fan_in), biases 0, BatchNorm scale 1,
    bias 0 and statistics (0, 1). The distributions are JAX's; the values
    cannot be (another generator)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                std = (1.0 / m.weight[0].numel()) ** 0.5 / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model


def resize(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """jax.image.resize(..., "bilinear") on NCHW: half-pixel centres, a
    triangle kernel widened by the scale when shrinking (antialiasing)."""
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False,
                         antialias=True)


def conv_bn(cin: int, cout: int, kernel: int = 3, stride: int = 1, dilation: int = 1,
            groups: int = 1) -> Tuple[nn.Conv2d, BatchNorm2d]:
    """A bias-free convolution padded to keep the size (at stride 1) and its
    BatchNorm(eps 1e-5)."""
    pad = dilation * (kernel // 2)
    return (nn.Conv2d(cin, cout, kernel, stride, pad, dilation=dilation, groups=groups,
                      bias=False),
            BatchNorm2d(cout))

