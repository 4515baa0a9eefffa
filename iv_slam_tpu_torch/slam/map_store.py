"""Fixed-capacity structure-of-arrays map store.

A copy of ``iv_slam_tpu/slam/map_store.py`` for the port (numpy only, the
same behaviour): importing the reference's module would run the JAX
package's ``__init__``. Only ``load`` differs, building the port's
``Frame`` from torch tensors.

Replacement for the reference's pointer-graph map
(Map/MapPoint/KeyFrame, src/Map.cc, src/MapPoint.cc, src/KeyFrame.cc):
landmarks and keyframes live in preallocated NumPy arrays indexed by id, so
any subset view (local BA window, projection search set) is a zero-copy
slice that ships straight to the device. The mutex web of the reference
(SURVEY.md §2e row 4) disappears: the host owns the store single-threaded,
and device kernels only ever see immutable snapshots.

Observation lists (point <-> keyframe-feature) are per-point dicts — small,
host-only bookkeeping; dense per-op arrays are built on demand.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamming distance between (..., 32) uint8 descriptor arrays."""
    x = np.bitwise_xor(a, b)
    return np.unpackbits(x, axis=-1).sum(axis=-1)


class MapStore:
    def __init__(
        self,
        max_points: int = 200_000,
        max_keyframes: int = 2_000,
        n_levels: int = 8,
        scale_factor: float = 1.2,
    ):
        self.max_points = max_points
        self.max_keyframes = max_keyframes
        self.scale_factors = scale_factor ** np.arange(n_levels, dtype=np.float32)
        self.n_levels = n_levels
        # serializes host map access between the tracking thread and the
        # LocalMapping worker (cfg.system.threaded_local_mapping) — the
        # reference's Map::mMutexMapUpdate (Tracking.cc:523). Reentrant:
        # worker sub-steps nest sections freely; uncontended (a few ns)
        # in single-threaded mode.
        import threading

        self.lock = threading.RLock()

        # --- map points -----------------------------------------------------
        self.pt_pos = np.zeros((max_points, 3), np.float32)
        self.pt_desc = np.zeros((max_points, 32), np.uint8)
        self.pt_normal = np.zeros((max_points, 3), np.float32)
        self.pt_min_dist = np.zeros(max_points, np.float32)
        self.pt_max_dist = np.zeros(max_points, np.float32)
        self.pt_alive = np.zeros(max_points, bool)
        self.pt_quality = np.ones(max_points, np.float32)
        self.pt_visible = np.zeros(max_points, np.int32)
        self.pt_found = np.zeros(max_points, np.int32)
        self.pt_first_kf = np.full(max_points, -1, np.int32)
        self.pt_ref_kf = np.full(max_points, -1, np.int32)
        self.pt_obs: List[Dict[int, int]] = [dict() for _ in range(max_points)]
        # incrementally-maintained weighted observation count (stereo
        # observations count 2, MapPoint::AddObservation) — the per-frame
        # tracking decisions (NeedNewKeyFrame, inlier accounting) read
        # thousands of counts per frame; the dict-walk version was a
        # measurable host tax on the 1-core box
        self.pt_n_obs = np.zeros(max_points, np.int32)
        self.n_points = 0
        # dirty-row tracking for the device-map delta sync
        # (slam/device_map.py): every mutation of a device-mirrored point
        # column (pos/desc/normal/dists/quality/alive) marks its row;
        # bulk rewrites (global BA merge, loop correction) set dirty_all.
        self._dirty = np.zeros(max_points, bool)
        self._dirty_all = True

        # --- keyframes ------------------------------------------------------
        self.kf_pose = np.zeros((max_keyframes, 4, 4), np.float32)  # Tcw
        self.kf_alive = np.zeros(max_keyframes, bool)
        self.kf_frame_id = np.full(max_keyframes, -1, np.int64)
        self.kf_timestamp = np.zeros(max_keyframes, np.float64)
        self.kf_frames: List[Optional[object]] = [None] * max_keyframes
        self.kf_gt_pose: List[Optional[np.ndarray]] = [None] * max_keyframes
        self.kf_img_name: List[str] = [""] * max_keyframes
        self.n_keyframes = 0
        self.origin_kf: int = -1
        self.poses_ver = 0  # bumped by set_kf_pose (see there)

    # --- device-mirror dirty tracking --------------------------------------

    def mark_dirty(self, pids):
        """Record that device-mirrored columns of these rows changed."""
        self._dirty[pids] = True

    def mark_all_dirty(self):
        self._dirty_all = True

    def take_dirty(self, n: int, cap: int):
        """Consume the dirty set for rows [0, n). Returns None when a full
        sync is required (dirty_all, or more than `cap` rows); otherwise
        the row indices, with the consumed flags cleared."""
        if self._dirty_all:
            self._dirty_all = False
            self._dirty[:n] = False
            return None
        idx = np.nonzero(self._dirty[:n])[0]
        if len(idx) > cap:
            self._dirty[:n] = False
            return None
        self._dirty[idx] = False
        return idx

    # --- point lifecycle ----------------------------------------------------

    def add_points_batch(self, pos: np.ndarray, ref_kf: int,
                         quality=1.0) -> np.ndarray:
        """Vectorized add_point for n new rows (the stereo keyframe
        event creates ~1000 close points in one shot; per-point calls
        cost ~10-20 ms of pure Python on the tracking thread). Rows are
        append-only, so a batch is a contiguous slice assignment."""
        n = len(pos)
        pid0 = self.n_points
        assert pid0 + n <= self.max_points, "map point capacity exhausted"
        pids = np.arange(pid0, pid0 + n)
        self.n_points += n
        self.pt_pos[pids] = pos
        self.pt_alive[pids] = True
        self.pt_quality[pids] = quality
        self.pt_first_kf[pids] = ref_kf
        self.pt_ref_kf[pids] = ref_kf
        self.pt_visible[pids] = 1
        self.pt_found[pids] = 1
        self._dirty[pids] = True
        return pids

    def add_point(
        self, pos: np.ndarray, ref_kf: int, quality: float = 1.0
    ) -> int:
        pid = self.n_points
        assert pid < self.max_points, "map point capacity exhausted"
        self.n_points += 1
        self.pt_pos[pid] = pos
        self.pt_alive[pid] = True
        self.pt_quality[pid] = quality
        self.pt_first_kf[pid] = ref_kf
        self.pt_ref_kf[pid] = ref_kf
        self.pt_visible[pid] = 1
        self.pt_found[pid] = 1
        self._dirty[pid] = True
        return pid

    def _obs_weight(self, kf_id: int, feat_idx: int) -> int:
        """Stereo observations count 2 (MapPoint::AddObservation)."""
        frame = self.kf_frames[kf_id]
        return 2 if (frame is not None and frame.u_right[feat_idx] >= 0) else 1

    def add_observation(self, pid: int, kf_id: int, feat_idx: int):
        old = self.pt_obs[pid].get(kf_id)
        if old is not None:
            self.pt_n_obs[pid] -= self._obs_weight(kf_id, old)
        self.pt_obs[pid][kf_id] = feat_idx
        self.pt_n_obs[pid] += self._obs_weight(kf_id, feat_idx)

    def erase_observation(self, pid: int, kf_id: int):
        old = self.pt_obs[pid].pop(kf_id, None)
        if old is not None:
            self.pt_n_obs[pid] -= self._obs_weight(kf_id, old)
        if self.pt_ref_kf[pid] == kf_id and self.pt_obs[pid]:
            self.pt_ref_kf[pid] = next(iter(self.pt_obs[pid]))
        # MapPoint::EraseObservation: dead when nObs <= 2 (stereo counts 2)
        if self.pt_n_obs[pid] <= 2:
            self.kill_point(pid)

    def kill_point(self, pid: int):
        if not self.pt_alive[pid]:
            return
        self.pt_alive[pid] = False
        self._dirty[pid] = True
        for kf_id, feat_idx in list(self.pt_obs[pid].items()):
            frame = self.kf_frames[kf_id]
            if frame is not None and frame.map_pt[feat_idx] == pid:
                frame.map_pt[feat_idx] = -1
        self.pt_obs[pid].clear()
        self.pt_n_obs[pid] = 0

    def retire_point(self, pid: int):
        """Drop a point whose observations were already rewired elsewhere
        (MapPoint::Replace tail): clears bookkeeping WITHOUT touching the
        observing frames' feature slots."""
        self.pt_obs[pid].clear()
        self.pt_n_obs[pid] = 0
        self.pt_alive[pid] = False
        self._dirty[pid] = True

    def n_observations(self, pid: int) -> int:
        """Weighted observation count (stereo counts 2) — incrementally
        maintained in pt_n_obs."""
        return int(self.pt_n_obs[pid])

    def compute_distinctive_descriptor(self, pid: int):
        """Min-median-Hamming descriptor among observations
        (MapPoint::ComputeDistinctiveDescriptors)."""
        descs = []
        for kf_id, feat_idx in self.pt_obs[pid].items():
            frame = self.kf_frames[kf_id]
            if frame is not None:
                descs.append(frame.desc[feat_idx])
        if not descs:
            return
        D = np.stack(descs)
        dist = _hamming_np(D[:, None, :], D[None, :, :])
        medians = np.median(np.sort(dist, axis=1), axis=1)
        self.pt_desc[pid] = D[int(np.argmin(medians))]
        self._dirty[pid] = True

    def compute_distinctive_descriptor_batch(self, pids):
        """Vectorized compute_distinctive_descriptor over many points —
        keyframe events touch thousands of points and the per-call numpy
        overhead of the scalar version dominates the host side of the
        event. Ragged observation lists are padded to the max count; the
        min-median-Hamming selection is identical."""
        pids = [int(p) for p in pids if self.pt_obs[p]]
        if not pids:
            return
        desc_rows = []   # per point: list of (32,) u8
        counts = np.empty(len(pids), np.int64)
        for i, p in enumerate(pids):
            rows = [
                self.kf_frames[k].desc[f]
                for k, f in self.pt_obs[p].items()
                if self.kf_frames[k] is not None
            ]
            counts[i] = len(rows)
            desc_rows.append(rows)
        cap = int(counts.max())
        if cap == 0:
            return
        P = len(pids)
        D = np.zeros((P, cap, 32), np.uint8)
        for i, rows in enumerate(desc_rows):
            if rows:
                D[i, : len(rows)] = rows
        dist = _hamming_np(D[:, :, None, :], D[:, None, :, :])  # (P,c,c)
        # mask padded columns with +inf so each row's median covers only
        # the real observations (ties to the scalar sort-then-median)
        j_ok = np.arange(cap)[None, :] < counts[:, None]        # (P, c)
        dist = np.where(j_ok[:, None, :], dist.astype(np.float32), np.inf)
        sorted_d = np.sort(dist, axis=2)
        lo = (counts - 1) // 2
        hi = counts // 2
        med = 0.5 * (
            np.take_along_axis(sorted_d, lo[:, None, None], axis=2)
            + np.take_along_axis(sorted_d, hi[:, None, None], axis=2)
        )[:, :, 0]                                              # (P, c)
        med = np.where(j_ok, med, np.inf)   # padded rows never win
        best = np.argmin(med, axis=1)
        valid = counts > 0
        idx = np.asarray(pids)[valid]
        self.pt_desc[idx] = D[np.arange(P)[valid], best[valid]]
        self._dirty[idx] = True

    def update_normal_and_depth_batch(self, pids):
        """Vectorized update_normal_and_depth over many points (one
        einsum for all camera centers, segment-summed unit normals)."""
        pids = [int(p) for p in pids if self.pt_obs[p]]
        if not pids:
            return
        counts = np.fromiter(
            (len(self.pt_obs[p]) for p in pids), np.int64, len(pids)
        )
        owner = np.repeat(np.arange(len(pids)), counts)
        flat_kf = np.fromiter(
            (k for p in pids for k in self.pt_obs[p]), np.int64,
            int(counts.sum()),
        )
        uniq, inv = np.unique(flat_kf, return_inverse=True)
        T = self.kf_pose[uniq]
        centers_u = -np.einsum("kji,kj->ki", T[:, :3, :3], T[:, :3, 3])
        centers = centers_u[inv]
        pid_arr = np.asarray(pids)
        pos = self.pt_pos[pid_arr]
        v = pos[owner] - centers
        n = np.linalg.norm(v, axis=1)
        ok = n > 1e-9
        vn = np.where(ok[:, None], v / np.maximum(n, 1e-12)[:, None], 0.0)
        sums = np.zeros((len(pids), 3), np.float64)
        np.add.at(sums, owner, vn)
        n_ok = np.zeros(len(pids), np.int64)
        np.add.at(n_ok, owner, ok)
        has = n_ok > 0
        self.pt_normal[pid_arr[has]] = (
            sums[has] / n_ok[has, None]
        ).astype(np.float32)
        self._dirty[pid_arr] = True

        # reference-keyframe scale range, grouped by ref keyframe
        refs = self.pt_ref_kf[pid_arr]
        for r in np.unique(refs):
            r = int(r)
            frame = self.kf_frames[r] if r >= 0 else None
            if frame is None:
                continue
            sel = np.nonzero(refs == r)[0]
            feats = np.array(
                [self.pt_obs[pids[i]].get(r, -1) for i in sel], np.int64
            )
            sel, feats = sel[feats >= 0], feats[feats >= 0]
            if len(sel) == 0:
                continue
            center = self.kf_camera_center(r)
            dist = np.linalg.norm(pos[sel] - center[None], axis=1)
            maxd = dist * self.scale_factors[frame.octave[feats]]
            self.pt_max_dist[pid_arr[sel]] = maxd
            self.pt_min_dist[pid_arr[sel]] = (
                maxd / self.scale_factors[self.n_levels - 1]
            )

    def update_normal_and_depth(self, pid: int):
        """Mean viewing direction + scale-invariance distance range
        (MapPoint::UpdateNormalAndDepth)."""
        if not self.pt_obs[pid]:
            return
        pos = self.pt_pos[pid]
        normals = []
        for kf_id in self.pt_obs[pid]:
            center = self.kf_camera_center(kf_id)
            v = pos - center
            n = np.linalg.norm(v)
            if n > 1e-9:
                normals.append(v / n)
        if normals:
            mean_n = np.mean(normals, axis=0)
            self.pt_normal[pid] = mean_n
        ref_kf = int(self.pt_ref_kf[pid])
        frame = self.kf_frames[ref_kf]
        if frame is None:
            return
        feat_idx = self.pt_obs[pid].get(ref_kf)
        if feat_idx is None:
            return
        dist = np.linalg.norm(pos - self.kf_camera_center(ref_kf))
        level = int(frame.octave[feat_idx])
        self.pt_max_dist[pid] = dist * self.scale_factors[level]
        self.pt_min_dist[pid] = (
            self.pt_max_dist[pid] / self.scale_factors[self.n_levels - 1]
        )
        self._dirty[pid] = True

    def increase_visible(self, pids):
        self.pt_visible[pids] += 1

    def increase_found(self, pids):
        self.pt_found[pids] += 1

    def found_ratio(self, pid: int) -> float:
        return self.pt_found[pid] / max(self.pt_visible[pid], 1)

    # --- keyframes ----------------------------------------------------------

    def add_keyframe(self, frame) -> int:
        kf_id = self.n_keyframes
        assert kf_id < self.max_keyframes, "keyframe capacity exhausted"
        self.n_keyframes += 1
        self.kf_pose[kf_id] = frame.pose
        self.kf_alive[kf_id] = True
        self.kf_frame_id[kf_id] = frame.frame_id
        self.kf_timestamp[kf_id] = frame.timestamp
        self.kf_frames[kf_id] = frame
        self.kf_gt_pose[kf_id] = frame.gt_pose
        self.kf_img_name[kf_id] = frame.img_name
        if self.origin_kf < 0:
            self.origin_kf = kf_id
        return kf_id

    def kf_camera_center(self, kf_id: int) -> np.ndarray:
        T = self.kf_pose[kf_id]
        return -T[:3, :3].T @ T[:3, 3]

    def set_kf_pose(self, kf_id: int, T: np.ndarray):
        self.kf_pose[kf_id] = T
        # generation counter for keyframe-pose rewrites (BA merges, loop
        # corrections): chained tracking validates its speculative
        # dispatches against this — a changed counter means the dispatch
        # saw stale poses and the frame re-tracks fresh
        self.poses_ver += 1
        frame = self.kf_frames[kf_id]
        if frame is not None:
            frame.pose = np.asarray(T, np.float32).copy()

    def covisible_keyframes(self, kf_id: int, min_weight: int = 15):
        """Keyframes sharing >= min_weight points with kf_id, sorted by
        weight desc (KeyFrame::UpdateConnections semantics)."""
        counter: Dict[int, int] = {}
        frame = self.kf_frames[kf_id]
        if frame is None:
            return []
        for pid in frame.map_pt:
            if pid < 0 or not self.pt_alive[pid]:
                continue
            for other in self.pt_obs[pid]:
                if other != kf_id:
                    counter[other] = counter.get(other, 0) + 1
        pairs = [(w, k) for k, w in counter.items() if w >= min_weight]
        if not pairs and counter:
            # reference: if no neighbor passes the threshold, connect the
            # single best one anyway
            best = max(counter.items(), key=lambda kv: kv[1])
            pairs = [(best[1], best[0])]
        pairs.sort(reverse=True)
        return [(k, w) for w, k in pairs]

    # --- persistence (an improvement over the reference, where map
    # save/load is an acknowledged TODO — System.h:165-167) ---------------

    def save(self, path: str):
        """Serialize the map (poses, points, observations, keyframe feature
        bundles) to one .npz archive."""
        import io
        import pickle

        n, k = self.n_points, self.n_keyframes
        frames = []
        for kf in range(k):
            f = self.kf_frames[kf]
            if f is None:
                frames.append(None)
            else:
                frames.append(
                    dict(
                        frame_id=f.frame_id, timestamp=f.timestamp,
                        xy=f.xy, octave=f.octave, angle=f.angle,
                        desc=f.desc, valid=f.valid,
                        u_right=f.u_right, depth=f.depth,
                        qual_score=f.qual_score, map_pt=f.map_pt,
                        pose=f.pose, img_name=f.img_name,
                        gt_pose=f.gt_pose,
                    )
                )
        blob = pickle.dumps(
            dict(obs=self.pt_obs[:n], frames=frames,
                 img_names=self.kf_img_name[:k])
        )
        np.savez_compressed(
            path,
            pt_pos=self.pt_pos[:n], pt_desc=self.pt_desc[:n],
            pt_normal=self.pt_normal[:n],
            pt_min_dist=self.pt_min_dist[:n], pt_max_dist=self.pt_max_dist[:n],
            pt_alive=self.pt_alive[:n], pt_quality=self.pt_quality[:n],
            pt_visible=self.pt_visible[:n], pt_found=self.pt_found[:n],
            pt_first_kf=self.pt_first_kf[:n], pt_ref_kf=self.pt_ref_kf[:n],
            kf_pose=self.kf_pose[:k], kf_alive=self.kf_alive[:k],
            kf_frame_id=self.kf_frame_id[:k],
            kf_timestamp=self.kf_timestamp[:k],
            origin_kf=self.origin_kf,
            blob=np.frombuffer(blob, np.uint8),
        )

    @staticmethod
    def load(path: str, **kwargs) -> "MapStore":
        import pickle

        import torch

        from .frame import Frame
        from ..ops.extractor import Keypoints

        z = np.load(path, allow_pickle=False)
        m = MapStore(**kwargs)
        n = len(z["pt_pos"])
        k = len(z["kf_pose"])
        m.n_points, m.n_keyframes = n, k
        for name in (
            "pt_pos", "pt_desc", "pt_normal", "pt_min_dist", "pt_max_dist",
            "pt_alive", "pt_quality", "pt_visible", "pt_found",
            "pt_first_kf", "pt_ref_kf",
        ):
            getattr(m, name)[:n] = z[name]
        m.kf_pose[:k] = z["kf_pose"]
        m.kf_alive[:k] = z["kf_alive"]
        m.kf_frame_id[:k] = z["kf_frame_id"]
        m.kf_timestamp[:k] = z["kf_timestamp"]
        m.origin_kf = int(z["origin_kf"])
        extra = pickle.loads(z["blob"].tobytes())
        m.pt_obs[:n] = extra["obs"]
        m.kf_img_name[:k] = extra["img_names"]
        for kf, fd in enumerate(extra["frames"]):
            if fd is None:
                continue
            kp = Keypoints(
                xy=torch.as_tensor(fd["xy"]),
                response=torch.zeros(len(fd["xy"])),
                octave=torch.as_tensor(fd["octave"]),
                angle=torch.as_tensor(fd["angle"]),
                desc=torch.as_tensor(fd["desc"]),
                valid=torch.as_tensor(fd["valid"]),
                yx_level=torch.zeros((len(fd["xy"]), 2), dtype=torch.int32),
            )
            f = Frame(
                frame_id=fd["frame_id"], timestamp=fd["timestamp"], kp=kp,
                u_right=fd["u_right"], depth=fd["depth"],
                qual_score=fd["qual_score"], pose=fd["pose"],
                map_pt=fd["map_pt"], img_name=fd["img_name"],
                gt_pose=fd["gt_pose"],
            )
            m.kf_frames[kf] = f
        for pid in range(n):  # rebuild the incremental counts
            m.pt_n_obs[pid] = sum(
                m._obs_weight(k, f) for k, f in m.pt_obs[pid].items()
            )
        return m

    def live_point_arrays(self):
        """Dense views over the allocated point range (for device ops)."""
        n = self.n_points
        return dict(
            pos=self.pt_pos[:n],
            desc=self.pt_desc[:n],
            normal=self.pt_normal[:n],
            min_dist=self.pt_min_dist[:n],
            max_dist=self.pt_max_dist[:n],
            alive=self.pt_alive[:n],
            quality=self.pt_quality[:n],
        )
