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
solve, the float64 error lies far below half a float32 ulp. ``log`` is the
exception: it is XLA:CPU's float32 logarithm (Eigen's Cephes polynomial)
written out in float32 operations, which round alike on both devices. The
reference takes ceil(log(maxDist / dist) / log(scaleFactor)) as a
predicted pyramid level, and a frame at its keyframe's pose sees a ratio of
exactly scaleFactor^k: there the quotient sits on an integer, and XLA's
log, one ulp off the correctly rounded value on ~9% of inputs, decides the
level. Products of
small matrices are written out as separate products and additions, summed
left to right, the order in which XLA reduces a short axis. A sum that must
keep float32 rounding, as the reference's does, is taken as a fixed
pairwise tree of float32 additions (``tree_sum``).

The introspection-weighted keypoint selection reproduces three more
roundings of jitted XLA:CPU (without FMA contraction), each found by
probing jnp on random inputs: ``x / c`` by a constant is ``x * f32(1 / c)``
(``quality``); a float32 sum over more than 32 elements is a sum of
32-wide windows centred on the padded axis (XLA's tree-reduction rewrite,
``xla_sum``); a cumulative sum is a left-to-right scan inside 16-wide
blocks plus the scanned block totals (XLA's reduce-window rewrite,
``xla_cumsum``). The budget of a cell is ceil(n * w / S) with S such a sum,
so one ulp of S can move a keypoint from one cell to another.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def rounded(fn, *xs: torch.Tensor) -> torch.Tensor:
    """fn of float32 tensors, evaluated in float64 and rounded to float32."""
    return fn(*(x.double() for x in xs)).float()


def sqrt(x: torch.Tensor) -> torch.Tensor:
    return rounded(torch.sqrt, x)


def sin(x: torch.Tensor) -> torch.Tensor:
    return rounded(torch.sin, x)


def cos(x: torch.Tensor) -> torch.Tensor:
    return rounded(torch.cos, x)


# Eigen's plog constants, as XLA:CPU emits them (float32)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_SQRT_HALF = 0.707106781186547524
_MIN_NORMAL = 1.17549435e-38


def log(x: torch.Tensor) -> torch.Tensor:
    """float32 natural logarithm, bit for bit XLA:CPU's jnp.log (without FMA
    contraction): split x = m 2^e with m in [sqrt(1/2), sqrt(2)), a degree-9
    polynomial in m - 1, and e log 2 added in two parts. Subnormal inputs
    count as 0, as XLA:CPU flushes them."""
    x = x.to(torch.float32)
    bits = torch.clamp(x, min=_MIN_NORMAL).contiguous().view(torch.int32)
    e = ((bits >> 23) - 0x7F).to(torch.float32) + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)   # in [0.5, 1)
    low = m < _SQRT_HALF
    tmp = torch.where(low, m, 0.0)
    m = m - 1.0
    e = e - torch.where(low, 1.0, 0.0)
    m = m + tmp
    m2 = m * m
    m3 = m2 * m
    p = _LOG_P
    y = p[0] * m + p[1]
    y1 = p[3] * m + p[4]
    y2 = p[6] * m + p[7]
    y = y * m + p[2]
    y1 = y1 * m + p[5]
    y2 = y2 * m + p[8]
    y = y * m3 + y1
    y = y * m3 + y2
    y = y * m3
    y = y + e * _LOG_Q1
    m = m - m2 * 0.5
    m = m + y
    m = m + e * _LOG_Q2
    m = torch.where(x == float("inf"), float("inf"), m)
    m = torch.where((x < 0) | torch.isnan(x), float("nan"), m)
    return torch.where((x >= 0) & (x < _MIN_NORMAL), float("-inf"), m)


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


def inverse(a: torch.Tensor) -> torch.Tensor:
    """Inverse of small (..., n, n) float32 matrices as LAPACK's getrf +
    getrs compute it (jnp.linalg.inv's route): LU with partial pivoting
    (the first row of largest magnitude; the column below the pivot scaled
    by its reciprocal; rank-1 updates), then the unit-lower and the upper
    triangular solves of the permuted identity, column by column. Each
    product and difference is its own rounded op, so the card and the CPU
    round alike (torch.linalg.inv does not)."""
    n = a.shape[-1]
    a = a.clone()
    idx = torch.arange(n, device=a.device)
    b = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape).clone()
    for k in range(n - 1):
        p = k + a[..., k:, k].abs().argmax(dim=-1, keepdim=True)     # (..., 1)
        perm = torch.where(idx == k, p, torch.where(idx == p, k, idx))
        rows = perm[..., :, None].expand(a.shape)
        a, b = a.gather(-2, rows), b.gather(-2, rows)
        l = a[..., k + 1:, k] * (1.0 / a[..., k, k])[..., None]
        a[..., k + 1:, k + 1:] = a[..., k + 1:, k + 1:] - l[..., :, None] * a[..., k, None, k + 1:]
        a[..., k + 1:, k] = l
    for k in range(n):             # L y = P I (unit lower)
        b[..., k + 1:, :] = b[..., k + 1:, :] - a[..., k + 1:, k, None] * b[..., k, None, :]
    for k in range(n - 1, -1, -1):  # U x = y
        b[..., k, :] = b[..., k, :] / a[..., k, k, None]
        b[..., :k, :] = b[..., :k, :] - a[..., :k, k, None] * b[..., k, None, :]
    return b


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


def quality(cost: torch.Tensor, den: float) -> torch.Tensor:
    """The reference's keypoint quality 2 / (1 + cost / den) - 1 of a
    float32 cost, with the division by the constant taken as XLA:CPU takes
    it: a product with the float32 reciprocal."""
    r = float(np.float32(1.0 / den))
    return 2.0 * (1.0 / (1.0 + cost.to(torch.float32) * r)) - 1.0


def quality_table(den: float) -> torch.Tensor:
    """``quality`` of every uint8 cost 0..255 as a (256,) float32 CPU table:
    a uint8 map's quality is a lookup, alike on every device."""
    return quality(torch.arange(256, dtype=torch.float32), den)


def _scan_last(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 scan along the last axis, left to right."""
    out = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., i])
    return torch.stack(out, dim=-1)


def xla_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """float32 cumulative sum along `dim` in XLA:CPU's order (jnp.cumsum):
    the axis is padded at its end to a multiple of 16, each 16-wide block
    is scanned left to right, and the block totals, scanned the same way
    (recursively), are added to the blocks after them."""
    x = x.to(torch.float32).movedim(dim, -1)
    n = x.shape[-1]
    if n <= 16:
        return _scan_last(x).movedim(-1, dim)
    nb = -(-n // 16)
    blocks = _scan_last(F.pad(x, (0, nb * 16 - n)).reshape(*x.shape[:-1], nb, 16))
    before = F.pad(xla_cumsum(blocks[..., -1], -1)[..., :-1], (1, 0))
    out = (blocks + before[..., None]).reshape(*x.shape[:-1], nb * 16)[..., :n]
    return out.movedim(-1, dim)


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last axis in XLA:CPU's order (jnp.sum): up to
    32 elements left to right; beyond, the axis is padded with zeros on
    both sides (the odd zero at the end) to a multiple of 32, each 32-wide
    window is summed left to right, and the window sums are summed the
    same way (recursively)."""
    x = x.to(torch.float32)
    n = x.shape[-1]
    if n > 32:
        nb = -(-n // 32)
        lo = (nb * 32 - n) // 2
        w = F.pad(x, (lo, nb * 32 - n - lo)).reshape(*x.shape[:-1], nb, 32)
        return xla_sum(_scan_last(w)[..., -1])
    s = x[..., 0]
    for i in range(1, n):
        s = s + x[..., i]
    return s
