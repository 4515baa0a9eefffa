"""float32 arithmetic that rounds the same on the CPU and on the GPU.

The tracking step makes discrete choices from float32 values: a point falls
inside a search window or not, an LM trial is accepted or not. A value one
ulp apart between the two devices can flip such a choice, and one edge more
or less in the pose LM moves the pose by about a millimetre. An elementwise
+, -, * or / of two tensors rounds correctly on both devices. These do not:

  * torch's CPU ``sqrt``, ``sin``, ``cos``, ``log`` and ``atan2`` are
    approximations (its float32 ``sqrt`` misses the rounded root on about
    15% of inputs), and CUDA's are other approximations;
  * ``x / c`` with a Python number ``c`` is ``x * (1 / c)`` on CUDA and a
    true division on the CPU;
  * ``matmul`` and ``sum`` order their additions, and fuse multiply-adds,
    as each device and library sees fit.

So those are computed here in float64 and rounded once to float32. For one
operation that gives the correctly rounded float32 result; for a sum or a
solve, the float64 error lies far below half a float32 ulp. Products of
small matrices are written out as separate products and additions, summed
left to right, the order in which XLA reduces a short axis. A sum that must
keep float32 rounding, as the reference's does, is taken as a fixed
pairwise tree of float32 additions (``tree_sum``).
"""

from __future__ import annotations

import torch


def rounded(fn, *xs: torch.Tensor) -> torch.Tensor:
    """fn of float32 tensors, evaluated in float64 and rounded to float32."""
    return fn(*(x.double() for x in xs)).float()


def sqrt(x: torch.Tensor) -> torch.Tensor:
    return rounded(torch.sqrt, x)


def sin(x: torch.Tensor) -> torch.Tensor:
    return rounded(torch.sin, x)


def cos(x: torch.Tensor) -> torch.Tensor:
    return rounded(torch.cos, x)


def log(x: torch.Tensor) -> torch.Tensor:
    return rounded(torch.log, x)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return rounded(torch.atan2, y, x)


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c for a Python number c, rounded as a true division."""
    return rounded(lambda t: t / c, x)


def total(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over one axis, accumulated in float64."""
    return x.sum(dim=dim, dtype=torch.float64).float()


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for a small inner size (3 or 4), broadcasting leading axes:
    each entry is a0 b0 + a1 b1 + ..., summed left to right."""
    out = a[..., :, :1] * b[..., :1, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return out


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the first axis in float32, as a fixed pairwise tree: the
    rows are padded with zeros to a power of two, then the upper half is
    added to the lower half until one row is left."""
    n = x.shape[0]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        x = torch.cat([x, x.new_zeros((p - n,) + tuple(x.shape[1:]))])
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x = x[:h] + x[h:]
    return x[0]
