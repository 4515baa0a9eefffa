"""Multi-process offline replay: the stereo frontend over many frames.

Port of ``iv_slam_tpu/parallel/replay.py``. The online tracking loop is
frame-recurrent and runs on one device; the offline passes (training-data
scoring, batch evaluation, dataset pre-extraction) are parallel across
frames. The JAX package stacks B stereo pairs and runs the frontend as one
program sharded over a 'dp' mesh. Here the frames are split over the ranks
of a ``mesh.DataParallel`` group (contiguous shares, as the dp sharding),
and each rank runs its frames one at a time through its
``StereoFrontend``: the three frontend kernels launch once a frame, and
each frame equals ``StereoFrontend.process`` on it. Batching several
frames into one launch is a later performance question.

The reference has no analogue: its offline replay is the same
single-threaded binary run per session (scripts/run_*_batch*.bash).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..config import Config
from ..slam.frame import StereoFrontend
from .mesh import DataParallel

_FIELDS = ("xy", "octave", "valid", "desc", "angle")


class ShardedReplay:
    """Frontend fan-out over the ranks for offline batch processing.

    ``process_batch(lefts, rights)`` takes (B, H, W) uint8 stacks and
    returns every frame's keypoints, stereo depth and quality as host
    arrays (and the BoW leaf-node ids, -1 where a keypoint is not valid,
    when a vocabulary is attached), on every rank."""

    def __init__(self, cfg: Config, height: int, width: int, dp: Optional[DataParallel] = None,
                 vocabulary=None, device=None):
        self.cfg = cfg
        self.dp = dp or DataParallel(0, 1)
        self.frontend = StereoFrontend(cfg, height, width, device)
        self.vocabulary = vocabulary

    def _frames(self, lefts: np.ndarray, rights: np.ndarray, idx) -> List[dict]:
        if len(idx) == 0:
            return []
        handles = [self.frontend.submit(lefts[i], rights[i]) for i in idx]
        dev = {f: torch.stack([getattr(h.kl, f) for h in handles]) for f in _FIELDS}
        dev.update(u_right=torch.stack([h.u_right for h in handles]),
                   depth=torch.stack([h.depth for h in handles]),
                   qual=torch.stack([h.qual for h in handles]))
        host = {k: v.cpu().numpy() for k, v in dev.items()}
        if self.vocabulary is not None:
            from ..ops import bow

            words = bow.transform_batch(self.vocabulary, dev["desc"])
            host["bow_nodes"] = np.where(host["valid"], words, -1)
        return [{k: v[j] for k, v in host.items()} for j in range(len(idx))]

    def process_batch(self, lefts: np.ndarray, rights: np.ndarray) -> List[dict]:
        """(B, H, W) x2 -> B dicts of host arrays (xy, octave, valid, desc,
        angle, u_right, depth, qual[, bow_nodes]), in frame order."""
        b = lefts.shape[0]
        mine = self._frames(lefts, rights, self.dp.items(b))
        if self.dp.world == 1:
            return mine
        import torch.distributed as dist

        parts = [None] * self.dp.world
        dist.all_gather_object(parts, mine)
        return [rec for part in parts for rec in part]
