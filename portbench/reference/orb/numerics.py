"""The float32 orders of the introspection-weighted keypoint selection:
the division by a constant as a product with its float32 reciprocal
(``quality``); a float32 sum over more than 32 elements as a sum of 32-wide
windows centred on the zero-padded axis (``xla_sum``); a cumulative sum as
a left-to-right scan inside 16-wide blocks plus the scanned block totals
(``xla_cumsum``). The budget of a cell is ceil(n * w / S) with S such a
sum, so one ulp of S can move a keypoint from one cell to another.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


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
