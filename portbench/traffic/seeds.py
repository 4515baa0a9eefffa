"""Seeds derived from the run's seed: one stream per purpose and index, so
that sessions and pools never share draws."""

from __future__ import annotations

import numpy as np


def child(seed: int, *keys: int) -> int:
    """A 63-bit seed for (seed, *keys); any non-negative int seed works."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *(int(k) for k in keys)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng(child(seed, *keys))
