"""ORB extraction parameters (the settings file's ``ORBextractor.*``;
scale pyramid and per-level budgets as ORBextractor.cc:411-478)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ORBConfig:
    n_features: int = 2000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 12
    min_th_fast: int = 7
    select_path: str = "hist"

    def scale_factors(self) -> np.ndarray:
        """Per-level scale factors [1, s, s^2, ...] (ORBextractor.cc:417-426)."""
        return self.scale_factor ** np.arange(self.n_levels, dtype=np.float32)

    def features_per_level(self) -> np.ndarray:
        """Geometric split of the feature budget (ORBextractor.cc:438-452)."""
        factor = 1.0 / self.scale_factor
        ndesired = self.n_features * (1.0 - factor) / (1.0 - factor ** self.n_levels)
        per_level = np.zeros(self.n_levels, dtype=np.int32)
        total = 0
        for lvl in range(self.n_levels - 1):
            per_level[lvl] = int(round(ndesired))
            total += per_level[lvl]
            ndesired *= factor
        per_level[self.n_levels - 1] = max(self.n_features - total, 0)
        return per_level
