"""Device-resident map mirror for the fused tracking step.

Port of ``iv_slam_tpu/slam/device_map.py``. Fixed-capacity map tables live
in device memory: a (capacity, 9) float32 pack [pos(3), normal(3),
min_dist, max_dist, quality], (capacity, 32) uint8 descriptors and a
(capacity,) valid mask. ``sync`` re-uploads only when the host map changed
(keyframe insertion, bundle adjustment, loop correction), so a tracking
step carries no map payload.

Every update builds NEW tensors and leaves the old ones as they were, as
the reference's non-donated programs do: a view captured by another thread
before a sync (the LocalMapping worker's, slam/local_mapping.py) stays valid.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device


def _splice(packed, desc, valid, packed_rows, desc_rows, valid_rows):
    """New tables whose first n rows are the given rows and whose other rows
    are the old tables'."""
    n = packed_rows.shape[0]
    return (torch.cat([packed_rows, packed[n:]]), torch.cat([desc_rows, desc[n:]]),
            torch.cat([valid_rows, valid[n:]]))


def _scatter(packed, desc, valid, idx, packed_rows, desc_rows, valid_rows):
    """New tables with rows idx replaced (the delta sync). Padded slots
    carry idx == capacity and are dropped: they land in one extra row that
    is cut off again (torch indexing, unlike ``mode="drop"``, does not drop
    out-of-range rows)."""
    out = []
    for table, rows in ((packed, packed_rows), (desc, desc_rows), (valid, valid_rows)):
        t = torch.cat([table, table[:1]])
        t[idx] = rows
        out.append(t[:-1])
    return tuple(out)


class DeviceMap:
    """Map tables on one device. ``device`` defaults to CUDA; with no CUDA
    device the caller must pass ``device="cpu"`` (the tests' path)."""

    # delta-sync row buckets: a x4 ladder; a dirty set larger than the top
    # bucket falls back to the full splice
    DELTA_RUNGS = (256, 1024, 4096)

    def __init__(self, capacity: int = 32768, device=None):
        self.device = resolve_device(device, "DeviceMap")
        self.capacity = capacity
        self._packed = torch.zeros((capacity, 9), dtype=torch.float32, device=self.device)
        self.desc = torch.zeros((capacity, 32), dtype=torch.uint8, device=self.device)
        self.valid = torch.zeros(capacity, dtype=torch.bool, device=self.device)
        self._reslice()
        self.live_cap = 1024
        self._set_views()

    def _reslice(self):
        dev = self._packed
        self.pos = dev[:, 0:3]
        self.normal = dev[:, 3:6]
        self.min_dist = dev[:, 6]
        self.max_dist = dev[:, 7]
        self.quality = dev[:, 8]

    def _set_views(self):
        c = self.live_cap
        self._views = (
            self.pos[:c], self.desc[:c], self.normal[:c], self.min_dist[:c],
            self.max_dist[:c], self.quality[:c], self.valid[:c],
        )

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _rows(self, m, idx, k, n_rows):
        """Host (n_rows, 9) pack, descriptors and valid flags of map rows
        idx (k of them) in the first k slots, zeros below."""
        packed = np.zeros((n_rows, 9), np.float32)
        packed[:k, 0:3] = m.pt_pos[idx]
        packed[:k, 3:6] = m.pt_normal[idx]
        packed[:k, 6] = m.pt_min_dist[idx]
        packed[:k, 7] = m.pt_max_dist[idx]
        packed[:k, 8] = m.pt_quality[idx]
        desc = np.zeros((n_rows, 32), np.uint8)
        desc[:k] = m.pt_desc[idx]
        valid = np.zeros(n_rows, bool)
        valid[:k] = m.pt_alive[idx]
        return self._upload(packed), self._upload(desc), self._upload(valid)

    def sync(self, m, force: bool = False):
        """Upload the live point tables from the host MapStore after
        keyframe insertion / BA / loop correction.

        Only rows [0, n_points) change (the arena is append-only; dead
        points flip `valid` in place), so the upload covers the live rung
        and is spliced into the full-capacity tables."""
        n = min(m.n_points, self.capacity)
        # x4 live rungs (1k/4k/16k/capacity): the shapes the fused step sees
        cap = 1024
        while cap < n:
            cap *= 4
        cap = min(cap, self.capacity)
        # delta path: when the live rung is unchanged and the host tracked
        # which rows mutated (MapStore._dirty), scatter just those rows
        if not force and cap == self.live_cap:
            idx = m.take_dirty(n, self.DELTA_RUNGS[-1])
            if idx is not None:
                if len(idx):
                    self._scatter_rows(m, idx)
                return
        else:
            m.take_dirty(n, -1)  # consume: the full splice covers it
        self._packed, self.desc, self.valid = _splice(
            self._packed, self.desc, self.valid, *self._rows(m, slice(0, n), n, cap))
        self._reslice()
        # live views: the fused step runs on the rung that covers the live
        # arena; slot indices into the slice equal full-table indices
        self.live_cap = cap
        self._set_views()

    def _scatter_rows(self, m, idx):
        """Upload only the dirty rows (idx) and scatter them into new
        tables; idx is padded to the smallest DELTA_RUNGS bucket with
        idx = capacity, which the scatter drops."""
        k = len(idx)
        cap = next(r for r in self.DELTA_RUNGS if r >= k)
        pidx = np.full(cap, self.capacity, np.int64)
        pidx[:k] = idx
        self._packed, self.desc, self.valid = _scatter(
            self._packed, self.desc, self.valid, self._upload(pidx),
            *self._rows(m, idx, k, cap))
        self._reslice()
        self._set_views()

    def live_views(self):
        """(pos, desc, normal, min_dist, max_dist, quality, valid) sliced
        to the current live rung."""
        return self._views

    def full_views(self):
        """(pos, desc, normal, min_dist, max_dist, valid) at FULL
        capacity: the same shapes whatever the live rung."""
        return (self.pos, self.desc, self.normal, self.min_dist,
                self.max_dist, self.valid)
