"""Local mapping per keyframe (LocalMapping.cc:47-170).

Port of ``iv_slam_tpu/slam/local_mapping.py``: the single-threaded
``loop_once`` path (the reference's LoopOnce, LocalMapping.cc:119-170)
and the worker thread (LocalMapping::Run, System.cc:172-197):

  ProcessNewKeyFrame -> MapPointCulling (236) -> CreateNewMapPoints (273)
  -> SearchInNeighbors (527) -> LocalBundleAdjustment (if > 2 keyframes
  and run_ba) -> KeyFrameCulling (705)

The device work of an event (triangulation against up to 16 covisible
neighbors in chunks of ``tri_chunk``, fusion in chunks of ``fuse_chunk``
targets, the local BA) runs on the device of the tracker's frames, each
call's host arrays shipped as one packed copy (utils/argpack.py); everything that
decides which points survive is host numpy, order for order the
reference's: dict insertion order of the observation lists and of
``recent_points``, ``covisible_keyframes`` order, ``np.unique`` in the fuse
assembly. Each device call is read back before the host applies it, so an
event waits for the device (a keyframe event is not held to zero syncs).

The local BA is the standard one or, by ``cfg.iv.ba_mode``: "vis", the
one that also updates each window point's quality from its edges' chi2;
"constrained", IV-SLAM's guided BA of training-data generation (keyframe
poses pinned to ground truth, each observation's chi2 a keypoint quality
label). With ``cfg.system.async_local_ba`` the standard one is deferred
(solvers/local_ba.py ``LBAHandle``): segmented and driven by the worker
off the map lock, or, without the worker, solved on this object's helper
thread; ``apply_pending_ba`` merges it. "vis" and "constrained" stay
synchronous, as in the reference.

The worker (``start_worker``; ``cfg.system.threaded_local_mapping``)
takes keyframes from ``kick_async`` and runs each event, then
``post_kf_hook`` (loop closing). Host map access is serialized by
``MapStore.lock`` with the reference's discipline: each stage snapshots
under the lock, runs its device calls without it, and re-locks to apply,
revalidating what it writes. A worker exception is stored and raised at
the next ``join``.

Threads and the card: the device is passed explicitly everywhere (the
current device is per thread). The worker and the BA helper launch on
the default stream, as the tracking thread does, so every tensor that
crosses threads (the mirror's ``full_views()``, the BA result, the fuse
tables) is ordered by the one stream, and the caching allocator and the
out-of-place mirror (slam/device_map.py) need no events. A side stream
would need ``record_stream`` or events at each of those handoffs, and
with a host-bound tracking step it would buy nothing measurable yet.
The TF32 switches are process-wide and set once at import; the FCN's
cuDNN flags are entered on the tracking thread only, and no worker op is
a convolution.

Program-shape families (``set_link_profile``, chosen by System from the
measured link, utils/linkprobe.py): chunked by default (8-neighbour
triangulation, 16-target fuse, the async local BA segmented under the
worker); a high-RTT link selects the monolithic ones (16 neighbours, 64
targets, one unsegmented solve), fewer host syncs per event. The two give
the same estimates. The ``IVT_FUSE_CHUNK`` and ``IVT_TRI_CHUNK``
environment variables, read at import, override the chunk sizes.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch

from ..config import Config
from ..ops import match as match_ops
from ..ops import triangulate as tri
from ..solvers import local_ba
from ..utils import argpack
from ..utils.profiling import span
from . import resolve_device

log = logging.getLogger(__name__)


class LocalMapping:
    # neighbors per triangulation call and targets per forward-fuse call of
    # the chunked family; the environment overrides them (a bisection aid)
    TRI_CHUNK = int(os.environ.get("IVT_TRI_CHUNK", "8"))
    FUSE_CHUNK = int(os.environ.get("IVT_FUSE_CHUNK", "16"))
    # reverse-fuse point-axis cap: the union of up to 64 covisible
    # keyframes' points; beyond it the candidate set is truncated
    P_CAP = 16384

    def __init__(self, cfg: Config, map_store, device=None):
        self.cfg = cfg
        self.map = map_store
        self.device = resolve_device(device, "LocalMapping")
        self.queue: List[int] = []
        # recently added points: pid -> kf_id when created
        self.recent_points: Dict[int, int] = {}
        # device map mirror (the tracker's DeviceMap), set by Tracking when
        # fused tracking runs: fuse gathers its candidate tables from it
        self.dmap = None
        # optional recorder of its stages (utils/profiling.py): None, the installed one
        self.stage_timer = None
        # per event: the BA rung solved; overflows of the compact tables
        self.ba_rungs: List[tuple] = []
        self.overflows = {"triangulate": 0, "fuse": 0}
        self._pending_ba = None   # in-flight async local BA (LBAHandle)
        self._ba_pool = None      # helper thread of the unsegmented async BA
        # worker-thread mode (start_worker)
        self._worker = None
        self.worker_exc = None
        self._map_changed = False  # worker -> tracking: resync the mirror
        self.post_kf_hook = None   # loop closing, installed by Tracking
        # program-shape family (set_link_profile): chunked by default
        self.fuse_chunk = self.FUSE_CHUNK
        self.tri_chunk = self.TRI_CHUNK
        self.monolithic_device = False
        cam = cfg.camera
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=self.device)  # noqa: E731
        self._cam = tuple(f32(v) for v in (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf))
        self._wh = (f32(cam.width), f32(cam.height))
        sf = map_store.scale_factors
        self._sf = torch.as_tensor(np.asarray(sf, np.float32), device=self.device)
        self._log_scale = f32(np.log(sf[1] / sf[0]) if len(sf) > 1 else 1.0)
        self._fuse_th = f32(3.0)

    def set_link_profile(self, high_rtt: bool):
        """Select the event's program-shape family from the measured link
        (SystemConfig.link_adaptive). high_rtt=True: the monolithic
        shapes (64-target fuse, 16-neighbour triangulation, one
        unsegmented async local BA), the fewest host syncs. The
        IVT_FUSE_CHUNK / IVT_TRI_CHUNK environment overrides win."""
        if "IVT_FUSE_CHUNK" not in os.environ:
            self.fuse_chunk = 64 if high_rtt else self.FUSE_CHUNK
        if "IVT_TRI_CHUNK" not in os.environ:
            self.tri_chunk = 16 if high_rtt else self.TRI_CHUNK
        self.monolithic_device = high_rtt

    def _up(self, a: np.ndarray) -> torch.Tensor:
        """One array to the device (a frame without its device tables)."""
        return argpack.upload([a], self.device)[0]

    def insert_keyframe(self, kf_id: int):
        self.queue.append(kf_id)
        frame = self.map.kf_frames[kf_id]
        for i in np.nonzero(frame.map_pt >= 0)[0]:
            pid = int(frame.map_pt[i])
            if self.map.pt_first_kf[pid] == kf_id:
                self.recent_points[pid] = kf_id

    def apply_pending_ba(self, only_if_ready: bool = False) -> bool:
        """Merge an in-flight async local BA; only_if_ready: merge only a
        finished one, never wait. The handle is taken under the map lock
        (tracking's poll and the worker's forced join can race here); the
        readback runs outside it. Returns True if a merge happened."""
        with self.map.lock:
            h = self._pending_ba
            if h is None or (only_if_ready and not h.is_ready()):
                return False
            self._pending_ba = None
        local_ba.apply_local_ba(h, self.map)
        return True

    def loop_once(self, run_ba: bool = True):
        while self.queue:
            kf_id = self.queue.pop(0)
            self._process_one(kf_id, run_ba)

    def _process_one(self, kf_id: int, run_ba: bool = True):
        # a keyframe event is a forced join point for the previous event's
        # async BA (its window overlaps this one)
        with span("lm_join_prev_ba", kf=kf_id, timer=self.stage_timer):
            self.apply_pending_ba()
        with span("lm_cull_points", kf=kf_id, timer=self.stage_timer), self.map.lock:
            self._cull_map_points(kf_id)
        with span("lm_triangulate", kf=kf_id, timer=self.stage_timer):
            self._create_new_map_points(kf_id)
        with span("lm_fuse", kf=kf_id, timer=self.stage_timer):
            self._search_in_neighbors(kf_id)
        if self.map.n_keyframes > 2 and run_ba:
            with span("lm_local_ba", kf=kf_id, timer=self.stage_timer):
                with self.map.lock:
                    self._run_local_ba(kf_id)
                # the worker steps a segmented async BA here, off the map
                # lock; without the worker, or in the monolithic family,
                # the helper thread solves it
                h = self._pending_ba
                if h is not None and self._worker is not None and not self.monolithic_device:
                    h.drive()
        with span("lm_cull_keyframes", kf=kf_id, timer=self.stage_timer), self.map.lock:
            self._cull_keyframes(kf_id)

    # ------------------------------------------------------ worker thread

    def start_worker(self):
        """Run keyframe events on a background thread, the reference's
        LocalMapping::Run thread."""
        if self._worker is not None:
            return
        self._q = queue.Queue()
        self.worker_exc = None
        self._worker = threading.Thread(target=self._worker_run, daemon=True,
                                        name="iv-local-mapping")
        self._worker.start()

    def _worker_run(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            kf_id, run_ba = item
            try:
                self._process_one(kf_id, run_ba)
                hook = self.post_kf_hook
                if hook is not None:
                    hook(kf_id)
            except Exception as e:  # raised at the next join()
                self.worker_exc = e
            finally:
                self._map_changed = True
                self._q.task_done()

    def kick_async(self, run_ba: bool = True):
        """Hand the queued keyframes to the worker (threaded loop_once)."""
        while self.queue:
            self._q.put((self.queue.pop(0), run_ba))

    def pending_count(self) -> int:
        """Keyframes not yet fully processed (the reference's
        mlNewKeyFrames.size() backpressure gate)."""
        if self._worker is None:
            return len(self.queue)
        return self._q.unfinished_tasks

    def poll_map_changed(self) -> bool:
        """One-shot: did the worker finish an event since the last poll?"""
        if self._map_changed:
            self._map_changed = False
            return True
        return False

    def join(self):
        """Forced join point (trajectory save, reset, shutdown): drain the
        worker's queue, raise a worker exception if one occurred, then
        merge any in-flight BA."""
        if self._worker is not None:
            self._q.join()
            if self.worker_exc is not None:
                e, self.worker_exc = self.worker_exc, None
                raise e
        self.apply_pending_ba()

    def stop_worker(self):
        """Stop the worker after its queue drains, then the BA helper."""
        if self._worker is not None:
            self._q.join()
            self._q.put(None)
            self._worker.join(timeout=60)
            self._worker = None
        if self._ba_pool is not None:
            self._ba_pool.shutdown(wait=True)
            self._ba_pool = None

    # -------------------------------------------------------- triangulation

    def _create_new_map_points(self, kf_id: int, n_neighbors: int = 10):
        """LocalMapping::CreateNewMapPoints (273-525): triangulate new points
        against the best covisible keyframes, one device call per chunk of
        tri_chunk neighbors (padded slots carry all-False free masks)."""
        m = self.map
        # host reads and uploads under the map lock; the device calls run
        # without it; the apply re-locks and revalidates
        with m.lock:
            snap = self._triangulation_args(kf_id, n_neighbors)
        if snap is None:
            return
        cur, cand, chunk_args = snap
        nb_cap = self.tri_chunk
        all_rows = []
        for ci, (n_chunk, args) in enumerate(chunk_args):
            flat = tri.triangulate_event_compact(*args).cpu().numpy()
            rows = flat[:-2].reshape(tri.T_CAP, 6)
            n_good, n_matched = int(flat[-2]), int(flat[-1])
            if n_matched > tri.T_CAP:
                self.overflows["triangulate"] += 1
                log.warning("triangulate_event: %d epipolar matches > cap %d; extras "
                            "dropped this event", n_matched, tri.T_CAP)
            rows = rows[: min(n_good, tri.T_CAP)].copy()
            rows = rows[rows[:, 0] < n_chunk]      # range guard on padded slots
            rows[:, 0] += ci * nb_cap              # chunk-local -> global index
            all_rows.append(rows)
        rows = np.concatenate(all_rows) if all_rows else np.zeros((0, 6), np.float32)

        with m.lock:
            new_pids = []
            for nb_i, f1, f2, x, y, z in rows:
                c = cand[int(nb_i)]
                nf = c["nf"]
                f1, f2 = int(f1), int(f2)
                if cur.map_pt[f1] >= 0 or nf.map_pt[f2] >= 0:
                    continue
                pid = m.add_point(np.array([x, y, z], np.float32), kf_id)
                m.add_observation(pid, kf_id, f1)
                m.add_observation(pid, c["nb"], f2)
                cur.map_pt[f1] = pid
                nf.map_pt[f2] = pid
                new_pids.append(pid)
                self.recent_points[pid] = kf_id
            m.compute_distinctive_descriptor_batch(new_pids)
            m.update_normal_and_depth_batch(new_pids)

    def _triangulation_args(self, kf_id: int, n_neighbors: int):
        """The host gates and each chunk's device arguments of
        _create_new_map_points: (cur, cand, [(chunk size, args), ...]), or
        None."""
        m = self.map
        cam = self.cfg.camera
        cur = m.kf_frames[kf_id]
        if cur is None:
            return None
        K = cam.K().astype(np.float64)
        Kinv = np.linalg.inv(K)
        T1 = m.kf_pose[kf_id]
        O1 = m.kf_camera_center(kf_id)
        free1 = cur.valid & (cur.map_pt < 0)
        if free1.sum() < 5:
            return None
        is_mono = cur.depth.max() <= 0

        # host gates + per-neighbor tables (LocalMapping.cc:295-330)
        cand = []
        for nb, _w in m.covisible_keyframes(kf_id)[:n_neighbors]:
            T2 = m.kf_pose[nb]
            O2 = m.kf_camera_center(nb)
            baseline = float(np.linalg.norm(O2 - O1))
            if is_mono:
                # mono gate: baseline / median scene depth > 0.01
                med_depth = self._median_scene_depth(nb)
                if med_depth <= 0 or baseline / med_depth < 0.01:
                    continue
            elif baseline < cam.baseline:
                # stereo gate: baseline must exceed the stereo baseline
                continue
            nf = m.kf_frames[nb]
            free2 = nf.valid & (nf.map_pt < 0)
            if free2.sum() < 5:
                continue
            # epipole of cam1 in image 2
            c1_in2 = T2[:3, :3] @ O1 + T2[:3, 3]
            if abs(c1_in2[2]) < 1e-6:
                continue
            epipole2 = np.array(
                [cam.fx * c1_in2[0] / c1_in2[2] + cam.cx,
                 cam.fy * c1_in2[1] / c1_in2[2] + cam.cy], np.float32)
            # F12 = K^-T [t12]x R12 K^-1 (ComputeF12, LocalMapping.cc:609)
            R1m, t1m = T1[:3, :3], T1[:3, 3]
            R2m, t2m = T2[:3, :3], T2[:3, 3]
            R12 = R1m @ R2m.T
            t12 = -(R12 @ t2m) + t1m
            tx = np.array([[0.0, -t12[2], t12[1]],
                           [t12[2], 0.0, -t12[0]],
                           [-t12[1], t12[0], 0.0]])
            F12 = (Kinv.T @ tx @ R12 @ Kinv).astype(np.float32)
            cand.append(dict(nb=nb, nf=nf, T2=T2, free2=free2, F12=F12,
                             epipole2=epipole2))
        if not cand:
            return None

        nb_cap = self.tri_chunk
        cand = cand[:16]
        f32s = np.float32

        def dev_or_up(t, a):
            return t if t is not None else self._up(np.asarray(a, f32s))

        def build_args(chunk):
            pad = [chunk[0]] * (nb_cap - len(chunk))
            rows = chunk + pad

            def dstack(get):
                return torch.stack([get(c) for c in rows])

            free2 = np.stack([c["free2"] for c in chunk]
                             + [np.zeros_like(chunk[0]["free2"])] * len(pad))
            # the keypoint tables stack from the frames' device tensors; the
            # free masks, the epipolar geometry and the poses ride one
            # packed copy, made here under the map lock
            return argpack.to_device((
                cur.kp.xy, cur.kp.desc, free1,
                dev_or_up(cur.ur_dev, cur.u_right), dev_or_up(cur.depth_dev, cur.depth),
                cur.kp.octave,
                dstack(lambda c: c["nf"].kp.xy),
                dstack(lambda c: c["nf"].kp.desc),
                free2,
                dstack(lambda c: dev_or_up(c["nf"].ur_dev, c["nf"].u_right)),
                dstack(lambda c: dev_or_up(c["nf"].depth_dev, c["nf"].depth)),
                dstack(lambda c: c["nf"].kp.octave),
                np.stack([c["F12"] for c in rows]).astype(f32s),
                np.stack([c["epipole2"] for c in rows]).astype(f32s),
                np.full(nb_cap, is_mono),
                np.array(T1, f32s),
                np.stack([c["T2"] for c in rows]).astype(f32s),
                self._sf, *self._cam,
            ), self.device)

        chunks = [cand[i:i + nb_cap] for i in range(0, len(cand), nb_cap)]
        return cur, cand, [(len(chunk), build_args(chunk)) for chunk in chunks]

    def _median_scene_depth(self, kf_id: int) -> float:
        """KeyFrame::ComputeSceneMedianDepth: median z of the keyframe's map
        points in its camera frame."""
        m = self.map
        frame = m.kf_frames[kf_id]
        T = m.kf_pose[kf_id]
        pids = frame.map_pt[frame.map_pt >= 0]
        pids = pids[m.pt_alive[pids]]
        if len(pids) == 0:
            return -1.0
        z = (m.pt_pos[pids] @ T[:3, :3].T + T[:3, 3])[:, 2]
        return float(np.median(z))

    # --------------------------------------------------------------- fuse

    def _search_in_neighbors(self, kf_id: int):
        """LocalMapping::SearchInNeighbors (527-607): fuse the current
        keyframe's points into its 2-hop covisible keyframes and theirs into
        it; the host applies the returned (target, point, feature) triples
        in order, revalidating liveness."""
        m = self.map
        # snapshot under the map lock (the mirror sync and the assembly),
        # the device calls without it, the apply re-locked (it revalidates)
        with m.lock:
            if self.dmap is not None:
                # the indexed fuse gathers from the mirror: bring this
                # event's triangulated points into it first
                self.dmap.sync(m)
            calls = self._assemble_fuse(kf_id)
        results = [(targets, pid_arr, fn(*args).cpu().numpy())
                   for fn, args, targets, pid_arr in calls]
        with m.lock:
            for targets, pid_arr, flat in results:
                triples = flat[:-1].reshape(match_ops.F_CAP, 3)
                count = int(flat[-1])
                if count > match_ops.F_CAP:
                    self.overflows["fuse"] += 1
                    log.warning("fuse: %d matches > cap %d; extras dropped this event",
                                count, match_ops.F_CAP)
                triples = triples[: min(count, match_ops.F_CAP)].astype(np.int64)
                triples = triples[triples[:, 0] < len(targets)]
                self._apply_fuse_triples(kf_id, targets, pid_arr, triples)

    def _assemble_fuse(self, kf_id: int):
        """The fuse calls: FORWARD chunks (<= fuse_chunk covisible targets x
        the current keyframe's points), then the REVERSE call (the current
        keyframe as the single target x the union of the targets' points).
        Returns [(fn, args, targets, pid_arr), ...]."""
        m = self.map
        targets = []
        for nb, _w in m.covisible_keyframes(kf_id)[:10]:
            targets.append(nb)
            for nb2, _w2 in m.covisible_keyframes(nb)[:5]:
                if nb2 != kf_id and nb2 not in targets:
                    targets.append(nb2)
        cur = m.kf_frames[kf_id]
        mp = cur.map_pt[cur.map_pt >= 0]
        cur_pts = mp[m.pt_alive[mp]]          # feature order
        if targets:
            all_nb = np.concatenate([m.kf_frames[nb].map_pt for nb in targets])
            all_nb = all_nb[all_nb >= 0]
            fuse_pts = np.unique(all_nb[m.pt_alive[all_nb]])
        else:
            fuse_pts = np.zeros(0, np.int64)
        targets = targets[:64]
        if not targets:
            return []
        calls = []
        if len(cur_pts):
            for i in range(0, len(targets), self.fuse_chunk):
                calls.append(self._fuse_args(targets[i:i + self.fuse_chunk], cur_pts,
                                             fwd_p_cap=2048))
        if len(fuse_pts):
            calls.append(self._fuse_args([kf_id], fuse_pts))
        return calls

    def _fuse_args(self, targets, pts, fwd_p_cap=None):
        m = self.map
        if fwd_p_cap is not None:
            p_cap = fwd_p_cap          # frame capacity bounds cur_pts
            pts = pts[:p_cap]
        else:
            pts = pts[: self.P_CAP]
            p_cap = 4096
            while p_cap < len(pts):
                p_cap *= 2
            p_cap = min(p_cap, self.P_CAP)
        pid_arr = np.asarray(pts, np.int64)
        # target-axis rungs {1, 16, 64}: 1 is the reverse side's shape
        nb_cap = 1 if len(targets) == 1 else (16 if len(targets) <= 16 else 64)
        frames = [m.kf_frames[nb] for nb in targets]
        rows = frames + [frames[0]] * (nb_cap - len(targets))
        kf_args = (
            torch.stack([f.kp.xy for f in rows]),
            torch.stack([f.kp.octave for f in rows]),
            torch.stack([f.kp.desc for f in rows]),
            torch.stack([f.kp.valid for f in rows]),
            torch.stack([f.ur_dev if f.ur_dev is not None
                         else self._up(np.asarray(f.u_right, np.float32)) for f in rows]),
            np.stack([m.kf_pose[nb] for nb in targets]
                     + [m.kf_pose[targets[0]]] * (nb_cap - len(targets))).astype(np.float32),
        )
        tail = (self._sf, self._log_scale, *self._cam[:4], *self._wh, self._cam[4],
                self._fuse_th)
        dmap = self.dmap
        if dmap is not None and pid_arr.size and pid_arr.max() < dmap.capacity:
            # indexed path: candidate tables gathered from the synced mirror
            pid_idx = np.full(p_cap, dmap.capacity, np.int32)
            pid_idx[: len(pts)] = pid_arr
            kf_ok = np.zeros(nb_cap, bool)
            kf_ok[: len(targets)] = True
            args = argpack.to_device((*kf_args, kf_ok, *dmap.full_views(), pid_idx, *tail),
                                     self.device)
            return match_ops.fuse_into_keyframes_compact_indexed, args, targets, pid_arr

        # no device mirror (classic tracking): upload the candidate tables
        mask = np.zeros((nb_cap, p_cap), bool)
        mask[: len(targets), : len(pts)] = True
        pos = np.zeros((p_cap, 3), np.float32)
        desc = np.zeros((p_cap, 32), np.uint8)
        normal = np.zeros((p_cap, 3), np.float32)
        mind = np.ones(p_cap, np.float32)
        maxd = np.ones(p_cap, np.float32)
        pos[: len(pts)] = m.pt_pos[pid_arr]
        desc[: len(pts)] = m.pt_desc[pid_arr]
        normal[: len(pts)] = m.pt_normal[pid_arr]
        mind[: len(pts)] = m.pt_min_dist[pid_arr]
        maxd[: len(pts)] = m.pt_max_dist[pid_arr]
        args = argpack.to_device((*kf_args, pos, desc, normal, mind, maxd, mask, *tail),
                                 self.device)
        return match_ops.fuse_into_keyframes_compact, args, targets, pid_arr

    def _apply_fuse_triples(self, kf_id, all_targets, pid_arr, triples):
        """Apply the compacted (target, point, feature) fuse matches in
        order."""
        m = self.map
        touched = set()
        for t, i, feat in triples:
            nb = all_targets[int(t)]
            frame = m.kf_frames[nb]
            pid = int(pid_arr[i])
            if not m.pt_alive[pid] or nb in m.pt_obs[pid]:
                continue
            feat = int(feat)
            existing = int(frame.map_pt[feat])
            if existing >= 0 and m.pt_alive[existing]:
                # keep the better-observed point (MapPoint::Replace)
                if m.n_observations(existing) >= m.n_observations(pid):
                    keep, drop = existing, pid
                else:
                    keep, drop = pid, existing
                for okf, ofeat in list(m.pt_obs[drop].items()):
                    of = m.kf_frames[okf]
                    if okf not in m.pt_obs[keep]:
                        m.add_observation(keep, okf, ofeat)
                        of.map_pt[ofeat] = keep
                    else:
                        of.map_pt[ofeat] = -1
                m.retire_point(drop)
                touched.add(keep)
            else:
                m.add_observation(pid, nb, feat)
                frame.map_pt[feat] = pid
                touched.add(pid)
        alive = [p for p in touched if m.pt_alive[p]]
        m.compute_distinctive_descriptor_batch(alive)
        m.update_normal_and_depth_batch(alive)

    # ------------------------------------------------------------- culling

    def _cull_map_points(self, kf_id: int):
        """MapPointCulling (LocalMapping.cc:236-271): recently created points
        must prove themselves (found/visible ratio, observations). Threshold:
        3 observations for stereo."""
        th_obs = 2 if self.cfg.system.sensor == "mono" else 3
        for pid in list(self.recent_points):
            first_kf = self.recent_points[pid]
            if not self.map.pt_alive[pid]:
                del self.recent_points[pid]
                continue
            age = kf_id - first_kf
            if self.map.found_ratio(pid) < 0.25:
                self.map.kill_point(pid)
                del self.recent_points[pid]
            elif age >= 2 and self.map.n_observations(pid) <= th_obs:
                self.map.kill_point(pid)
                del self.recent_points[pid]
            elif age >= 3:
                del self.recent_points[pid]

    def _cull_keyframes(self, kf_id: int):
        """KeyFrameCulling (LocalMapping.cc:705-780): a local keyframe is
        redundant if >= 90% of its points are seen by >= 3 other keyframes
        at the same or finer scale."""
        for cand, _w in self.map.covisible_keyframes(kf_id):
            if cand == self.map.origin_kf or not self.map.kf_alive[cand]:
                continue
            frame = self.map.kf_frames[cand]
            n_pts = 0
            n_redundant = 0
            for i in np.nonzero(frame.map_pt >= 0)[0]:
                pid = int(frame.map_pt[i])
                if not self.map.pt_alive[pid]:
                    continue
                # stereo: only close points (LocalMapping.cc:728-732)
                if frame.depth[i] > self.cfg.camera.depth_threshold or frame.depth[i] < 0:
                    continue
                n_pts += 1
                if self.map.n_observations(pid) <= 3:
                    continue
                scale_level = frame.octave[i]
                n_obs_finer = 0
                for okf, ofeat in self.map.pt_obs[pid].items():
                    if okf == cand:
                        continue
                    if self.map.kf_frames[okf].octave[ofeat] <= scale_level + 1:
                        n_obs_finer += 1
                        if n_obs_finer >= 3:
                            break
                if n_obs_finer >= 3:
                    n_redundant += 1
            if n_pts > 0 and n_redundant > 0.9 * n_pts:
                self._erase_keyframe(cand)

    def _erase_keyframe(self, kf_id: int):
        frame = self.map.kf_frames[kf_id]
        for i in np.nonzero(frame.map_pt >= 0)[0]:
            pid = int(frame.map_pt[i])
            if self.map.pt_alive[pid]:
                self.map.erase_observation(pid, kf_id)
        self.map.kf_alive[kf_id] = False

    # ----------------------------------------------------------------- BA

    def _run_local_ba(self, kf_id: int):
        mode = self.cfg.iv.ba_mode
        if mode not in ("vis", "constrained") and self.cfg.system.async_local_ba:
            # tracking goes on against the pre-BA map; the merge lands at
            # the next forced join (or, without the worker, when tracking's
            # per-frame poll finds it done). Segmented under the worker,
            # which drives it off the map lock; else on the helper thread
            segmented = self._worker is not None and not self.monolithic_device
            if not segmented and self._ba_pool is None:
                self._ba_pool = ThreadPoolExecutor(max_workers=1,
                                                   thread_name_prefix="iv-local-ba")
            h = local_ba.local_bundle_adjustment_async(
                self.cfg, self.map, kf_id, self.device, segmented=segmented,
                executor=self._ba_pool)
            self._pending_ba = h
            self.ba_rungs.append(None if h is None else h.rung)
            return
        ba = {"vis": local_ba.local_bundle_adjustment_vis,
              "constrained": local_ba.constrained_local_bundle_adjustment,
              }.get(mode, local_ba.local_bundle_adjustment)
        self.ba_rungs.append(ba(self.cfg, self.map, kf_id, self.device))
