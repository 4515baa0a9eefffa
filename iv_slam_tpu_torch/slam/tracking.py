"""The per-frame tracking state machine (src/Tracking.cc re-designed).

Port of ``iv_slam_tpu/slam/tracking.py``, unchained, for the stereo,
monocular and RGB-D sensors, single-threaded (the reference's
bSingleThreaded path, System.cc:177-189) or threaded:

  NOT_INITIALIZED -> StereoInitialization (Tracking.cc:882; stereo and
          RGB-D) | MonocularInitialization (951: the H/F initializer of
          solvers/initializer.py over two frames, median-depth scaling)
  OK   -> the fused step (slam/fused_track.py) when
          cfg.system.fused_tracking, else or on its failure
          TrackWithMotionModel (1303) | TrackReferenceKeyFrame (1154; by
          SearchByBoW when a vocabulary is attached and use_bow is on)
          -> TrackLocalMap (1509)
       -> NeedNewKeyFrame (1694) / CreateNewKeyFrame -> LocalMapping.LoopOnce
          -> LoopClosing.process_keyframe (enable_loop_closing)
          (cfg.system.threaded_local_mapping: handed to the LocalMapping
          worker with loop closing as its post-event hook)
  LOST -> Relocalization (use_bow), else failure accounting + reset
          (829-854) and re-initialization

Extraction, stereo matching, the projection searches, the pose LM and the
keyframe event's device work run on one device (``device``: CUDA unless
the caller asks for the CPU, as the tests do); this module is the host
orchestrator that owns the map store.

A frame's introspection cost map (``track_stereo(..., cost_map=...)``, or
an FCN attached to ``frontend``) weights its extraction and seeds its
keypoints' quality, which scales the Huber deltas of the pose LM and of
local BA; ``cfg.iv.ba_mode == "vis"`` also updates map-point quality in BA.

With a vocabulary attached (``attach_vocabulary``) the keyframe database
and the shared BoW cache exist; ``cfg.system.enable_loop_closing`` runs
``LoopClosing.process_keyframe`` inline after each keyframe event, and a
deferred global BA merges at the next frame's poll. ``only_tracking`` (System's
localization mode) tracks against the map without inserting keyframes,
carrying the motion model on temporary VO points.

With ``enable_datagen`` (and ``cfg.iv.enabled``, not
``inference_mode``) every tracked frame past the second feeds IV-SLAM's
training-data generation (introspection/datagen.py): supervised scoring
against ground-truth poses, or, with ``cfg.iv.unsupervised_learning``, the
pose LM's chi2 of each match, which ``_pose_optimize`` and the fused step
record on the frame. A GT depth map (``gt_depth_map``) is sampled per
keypoint for the evaluator.

The RANSACs draw their hypotheses through samplers called as
sampler(frame_id, valid, device): ``self.pnp_sampler`` (relocalization's
PnP, default ``pnp.sample_pnp``) and ``self.init_sampler`` (the monocular
initializer, default ``initializer.sample_init``).

The reference's thread architecture (System.cc:172-197):
``cfg.system.threaded_local_mapping`` runs keyframe events on the
LocalMapping worker (slam/local_mapping.py), and
``cfg.system.async_local_ba`` defers the local BA; every frame starts by
polling for finished background work (``_poll_async_merges``), and the
tracking thread takes ``map.lock`` where the reference does: the mirror
sync and the result bookkeeping of the fused step, and the keyframe
decision and creation. A busy worker (3 events queued) refuses new
keyframes unless the keyframe gap reaches ``max_frames`` with fewer than
6 queued.

Chained tracking (``cfg.system.chained_tracking`` with fused tracking,
stereo, no GT depth, not in localization mode; ``chain_depth`` frames in
flight): each frame's fused step is dispatched at once, from the previous
step's device results while a chain is live (FusedTracker.track_chained)
or from host state to start one, and its result pack is pulled to pinned
host memory behind a CUDA event; the host bookkeeping runs ``chain_depth``
frames behind and consumes a speculation only when its inputs are the
ones a fresh dispatch would see (no keyframe pose moved, MapStore
.poses_ver; no map event since its dispatch, the mirror version
``_mirror_ver``; the previous frame's fused result accepted). Otherwise
the head frame is dispatched fresh, with the unchained step's semantics,
and every queued frame is re-speculated from host state. ``flush_chain``
drains the queue: trajectory reads, shutdown, the non-chained entry
points. A chained ``track_stereo`` returns the pose of the frame it
finished (None while the queue fills).
"""

from __future__ import annotations

import collections
import enum
import logging
from typing import List, Optional

import numpy as np
import torch

from ..config import Config
from ..geometry import camera
from ..ops import match as match_ops
from ..ops import bow_match
from ..solvers import initializer, pnp, pose_opt
from ..utils import argpack
from ..utils.profiling import span
from . import resolve_device
from .device_map import DeviceMap
from .frame import Frame, MonoFrontend, RGBDFrontend, StereoFrontend, sample_gt_depth
from .fused_track import LOCAL_CAP, FusedTracker
from .local_mapping import LocalMapping
from .keyframe_db import KeyFrameBow, KeyFrameDatabase
from .loop_closing import LoopClosing
from .map_store import MapStore

log = logging.getLogger(__name__)


class State(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


class Tracking:
    def __init__(self, cfg: Config, height: int, width: int, device=None):
        self.cfg = cfg
        self.height = height
        self.width = width
        self.device = dev = resolve_device(device, "Tracking")
        self.frontend = StereoFrontend(cfg, height, width, device=dev)
        self.map = MapStore(n_levels=cfg.orb.n_levels, scale_factor=cfg.orb.scale_factor)
        self.local_mapping = LocalMapping(cfg, self.map, dev)
        if cfg.system.threaded_local_mapping:
            self._setup_threaded_mapping()
        self.K = camera.Intrinsics.from_config(cfg.camera, dev)
        self.state = State.NO_IMAGES_YET
        self.last_frame: Optional[Frame] = None
        self.current: Optional[Frame] = None
        self.velocity: Optional[np.ndarray] = None  # Tcl: cur <- last
        self.ref_kf: int = -1
        self.last_kf_frame_id: int = -1
        self.local_kfs: List[int] = []
        self.local_pts: np.ndarray = np.zeros(0, np.int64)
        self.n_inliers = 0
        # localization-only mode (System.activate_localization_mode)
        self.only_tracking = False
        self._temporal_points: List[int] = []
        self.pnp_sampler = pnp.sample_pnp
        self.init_sampler = initializer.sample_init
        self.datagen = None  # introspection DataGenerator (training mode)
        self.min_frames = 0
        self.max_frames = int(cfg.camera.fps)
        # the fused step and its device map mirror, built at first use
        self._fused: Optional[FusedTracker] = None
        self._dmap: Optional[DeviceMap] = None
        self._dmap_dirty = True  # the mirror needs a (re)sync
        # the mirror's content version: bumped by every map event that voids
        # in-flight speculative steps (worker events, BA and global-BA
        # merges, loop corrections, resets). A speculation stamps it at
        # dispatch and is consumed only while it is unchanged. _dmap_dirty
        # alone would not do: a later frame's dispatch clears it after the
        # resync, and an older speculation, computed against since-recycled
        # rows, would then pass
        self._mirror_ver = 0
        # chained tracking: dispatched frames not yet processed, oldest
        # first (at most chain_depth once full); the record _track_fused
        # consumes; whether the last processed frame's fused result was
        # accepted and its speculation used
        self._pendq = collections.deque()
        self._spec = None
        self._chain_ok = False
        self._used_spec = False

        sf = cfg.orb.scale_factors()
        self.inv_level_sigma2 = (1.0 / (sf * sf)).astype(np.float32)
        self.scale_factors_t = torch.as_tensor(sf, dtype=torch.float32, device=dev)
        self.log_scale = float(np.log(cfg.orb.scale_factor))

        # trajectory bookkeeping (Tracking.h:180-183)
        self.rel_poses: List[np.ndarray] = []   # Tcr per frame
        self.rel_refs: List[int] = []           # reference kf per frame
        self.frame_times: List[float] = []
        self.lost_flags: List[bool] = []
        self.failure_timestamps: List[float] = []
        self.failure_count = 0
        self._finalized_twc: List[np.ndarray] = []  # frames of closed sub-sessions
        self._session_start = 0
        # optional recorder of its stages (utils/profiling.py): None, the installed one
        self.stage_timer = None

    def _setup_threaded_mapping(self):
        """Start the LocalMapping worker (the reference's thread
        architecture, System.cc:172-197) and route loop closing through
        it: after each keyframe event the worker runs DetectLoop /
        ComputeSim3 / CorrectLoop, the reference's LoopClosing thread fed
        by LocalMapping's queue."""
        self.local_mapping.start_worker()

        def post_kf(kf_id: int):
            if not (self.cfg.system.enable_loop_closing and hasattr(self, "loop_closing")
                    and self.map.kf_alive[kf_id]):
                return
            # merge a finished global BA before a potential new correction
            if self.loop_closing.collect_gba():
                self._mark_mirror_stale()
            # a stale local-BA merge after CorrectLoop would overwrite the
            # corrected poses: join it first (the reference sets mbAbortBA
            # and mbStopGBA, LoopClosing.cc:437-449)
            self.local_mapping.apply_pending_ba()
            with self.map.lock:
                if self.loop_closing.process_keyframe(
                        kf_id, fix_scale=self.cfg.system.sensor != "mono"):
                    self._mark_mirror_stale()

        self.local_mapping.post_kf_hook = post_kf

    def _poll_async_merges(self):
        """Per-frame, non-blocking: merge finished background work (a
        deferred global BA, a worker's keyframe event, an async local BA);
        each merge marks the device mirror stale."""
        lc = getattr(self, "loop_closing", None)
        if lc is not None and lc.collect_gba(only_if_ready=True):
            self._mark_mirror_stale()
        # a finished worker event: resync the mirror before the next step
        if self.local_mapping.poll_map_changed():
            self._mark_mirror_stale()
        # a finished async local BA; under the worker the worker owns the
        # merge (its next event joins it)
        if (self.local_mapping._worker is None
                and self.local_mapping.apply_pending_ba(only_if_ready=True)):
            self._mark_mirror_stale()

    def _f32(self, v) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=self.device)

    def _up(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    # ------------------------------------------------------------------ API

    def track_stereo(
        self,
        img_left: np.ndarray,
        img_right: np.ndarray,
        timestamp: float,
        cost_map: Optional[np.ndarray] = None,
        gt_pose: Optional[np.ndarray] = None,
        gt_cov: Optional[np.ndarray] = None,
        img_name: str = "",
        frontend_handle=None,
        gt_depth_map: Optional[np.ndarray] = None,
    ) -> Optional[np.ndarray]:
        """Track one stereo pair; returns Tcw or None. Pass `frontend_handle`
        from `submit_frontend` (called while the previous frame was tracking)
        to overlap the frontend's device work with host-side tracking.

        In chained mode (cfg.system.chained_tracking) this frame's fused
        step is dispatched at once and the host bookkeeping runs
        chain_depth frames behind: the returned pose is the frame that
        finished (None until one has).

        gt_depth_map: optional full-resolution GT depth image (the AirSim PFM
        path, stereo_airsim.cc:339-360), sampled per keypoint as the
        reference's mvKeysGTDepth (Frame.cc:152-191)."""
        if (self.cfg.system.chained_tracking and self.cfg.system.fused_tracking
                and gt_depth_map is None and not self.only_tracking):
            return self._track_stereo_chained(img_left, img_right, timestamp, cost_map,
                                              gt_pose, gt_cov, img_name, frontend_handle)
        self.flush_chain()
        self._poll_async_merges()
        # the fused step reads the frame's device tensors, so the frontend's
        # host views can wait for the step's single download
        defer = (
            self.cfg.system.fused_tracking
            and self.state == State.OK
            and self.velocity is not None
            and not self.only_tracking
            and self.last_frame is not None
            and self.last_frame.pose is not None
            and gt_depth_map is None
        )
        with span("frontend", timer=self.stage_timer):
            if frontend_handle is not None:
                frame = self.frontend.collect(frontend_handle, timestamp, gt_pose, gt_cov,
                                              img_name, defer=defer)
            else:
                frame = self.frontend.process(img_left, img_right, timestamp, cost_map,
                                              gt_pose, gt_cov, img_name, defer=defer)
        if gt_depth_map is not None:
            frame.kp_gt_depth = sample_gt_depth(gt_depth_map, frame.xy, frame.valid)
        self.current = frame
        with span("track", timer=self.stage_timer):
            self._track()
        return frame.pose

    # ------------------------------------------------- chained (pipelined)

    def _track_stereo_chained(self, img_left, img_right, timestamp, cost_map, gt_pose,
                              gt_cov, img_name, frontend_handle) -> Optional[np.ndarray]:
        """Pipelined tracking: dispatch this frame's fused step now (chained
        off the queue tail's device results while a chain is live, else
        from host state), then process the oldest frame(s) once more than
        chain_depth are queued. A speculation is validated when its frame
        is processed (_track_fused)."""
        self._poll_async_merges()
        with span("frontend", timer=self.stage_timer):
            if frontend_handle is not None:
                frame = self.frontend.collect(frontend_handle, timestamp, gt_pose, gt_cov,
                                              img_name, defer=True)
            else:
                frame = self.frontend.process(img_left, img_right, timestamp, cost_map,
                                              gt_pose, gt_cov, img_name, defer=True)
        depth = max(1, int(self.cfg.system.chain_depth))
        q = self._pendq
        spec = None
        if q and self.state == State.OK and q[-1]["res"] is not None:
            tail = q[-1]
            # the version is read BEFORE the sync: an event landing at any
            # time after this makes the stamp mismatch at consumption (a
            # spurious mismatch costs one fresh dispatch)
            mver = self._mirror_ver
            self._sync_mirror()
            with span("spec_dispatch", frame=frame.frame_no, timer=self.stage_timer):
                res, flat = self._fused.track_chained(
                    frame, tail["frame"], tail["res"].assign_map, tail["res"].T,
                    tail["T_prev"], self._dmap)
            spec = dict(frame=frame, res=res, ver=self.map.poses_ver, mver=mver,
                        T_prev=tail["res"].T, pull=self._pull_async(flat))
        elif not q:
            spec = self._host_dispatch_spec(frame)
            if spec is None:
                # no pipeline (initialization, lost, fallback): process now
                self.current = frame
                with span("track", timer=self.stage_timer):
                    self._track()
                return frame.pose
        q.append(spec if spec is not None else dict(
            frame=frame, res=None, ver=-1, mver=-1, T_prev=None, pull=None))
        prev_pose = None
        while len(q) > depth:
            prev_pose = self._process_chain_head()
        return prev_pose

    def _sync_mirror(self):
        """Resync the device mirror if a map event made it stale (the flag
        is cleared BEFORE the sync: an event landing during it sets it
        again and the next dispatch resyncs)."""
        if self._dmap_dirty:
            self._dmap_dirty = False
            with span("dmap_sync", timer=self.stage_timer), self.map.lock:
                self._dmap.sync(self.map)

    def _ensure_fused(self):
        if self._fused is None:
            self._fused = FusedTracker(self.cfg, self.height, self.width, device=self.device)
            self._dmap = DeviceMap(device=self.device)
            self.local_mapping.dmap = self._dmap

    def _host_dispatch_spec(self, frame):
        """A fresh (unchained) speculative dispatch for `frame` from host
        state: valid only when `frame` directly follows last_frame (the
        queue is empty, or every earlier frame is processed). Returns the
        spec record, or None when the fused step's gate does not hold."""
        if not (self.state == State.OK and self.velocity is not None
                and self.last_frame is not None and self.last_frame.pose is not None):
            return None
        self._ensure_fused()
        mver = self._mirror_ver  # before the sync, as in the chained dispatch
        self._sync_mirror()
        self._update_last_frame()
        T_pred = self.velocity @ self.last_frame.pose
        with span("spec_dispatch", frame=frame.frame_no, timer=self.stage_timer):
            res, flat = self._fused.track(frame, self.last_frame, self.last_frame.map_pt,
                                          T_pred, self._dmap)
        T_prev = argpack.upload([np.asarray(self.last_frame.pose, np.float32)],
                                self.device)[0]
        return dict(frame=frame, res=res, ver=self.map.poses_ver, mver=mver, T_prev=T_prev,
                    pull=self._pull_async(flat))

    def _process_chain_head(self):
        """Pop and process the oldest queued frame. When its speculation was
        not used, its fused result was refused, or a map event voided the
        queued speculations, re-speculate the whole queue from the current
        host state (the head just became last_frame, so the first queued
        frame is its direct successor)."""
        q = self._pendq
        head = q.popleft()
        self.current = head["frame"]
        self._spec = head
        self._chain_ok = False
        self._used_spec = False
        with span("track", timer=self.stage_timer):
            self._track()
        self._spec = None
        stale = any(e["res"] is not None and e["mver"] != self._mirror_ver for e in q)
        if q and (not self._chain_ok or not self._used_spec or stale):
            self._respeculate_queue()
        return head["frame"].pose

    def _respeculate_queue(self):
        """Strip the queued speculations and rebuild them from host state:
        a fresh dispatch for the first queued frame, chained dispatches for
        the rest."""
        q = self._pendq
        for e in q:
            e.update(res=None, pull=None, ver=-1, mver=-1)
        mver_q = self._mirror_ver  # before any dispatch
        prev = None
        for e in q:
            if prev is None:
                spec = self._host_dispatch_spec(e["frame"])
                if spec is None:
                    return  # the gate does not hold (lost, reset): leave them fresh
                e.update(spec)
            else:
                with span("spec_dispatch", frame=e["frame"].frame_no, timer=self.stage_timer):
                    res, flat = self._fused.track_chained(
                        e["frame"], prev["frame"], prev["res"].assign_map, prev["res"].T,
                        prev["T_prev"], self._dmap)
                e.update(res=res, ver=self.map.poses_ver, mver=mver_q,
                         T_prev=prev["res"].T, pull=self._pull_async(flat))
            prev = e

    def _pull_async(self, flat: torch.Tensor):
        """Start the device-to-host copy of a result pack: a non-blocking
        copy into pinned host memory and a CUDA event recorded behind it
        (the consumer waits on the event before it reads, _pulled). On the
        CPU the pack is read at once."""
        if flat.device.type != "cuda":
            return flat.numpy(), None
        host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(flat.device))
        return host, ev

    @staticmethod
    def _pulled(pull) -> np.ndarray:
        """The host pack of a pull, once its copy has landed."""
        host, ev = pull
        if ev is None:
            return host
        ev.synchronize()
        return host.numpy()

    def flush_chain(self):
        """Drain the pipeline: process every queued frame, oldest first, so
        the host state is current (trajectory reads, shutdown, the
        non-chained entry points)."""
        q = self._pendq
        while q:
            self._process_chain_head()

    def submit_frontend(self, img_left, img_right, cost_map=None):
        handle = self.frontend.submit(img_left, img_right, cost_map)
        # the classic path downloads the host pack in collect(): start the
        # copy now; the fused step reads it with its own result instead
        if not self.cfg.system.fused_tracking:
            self.frontend.prefetch_host(handle)
        return handle

    def track_mono(
        self,
        img: np.ndarray,
        timestamp: float,
        cost_map: Optional[np.ndarray] = None,
        gt_pose: Optional[np.ndarray] = None,
        img_name: str = "",
        gt_depth_map: Optional[np.ndarray] = None,
    ) -> Optional[np.ndarray]:
        """Monocular tracking (Tracking::GrabImageMonocular): the H/F
        initializer builds the first map, then the per-frame loop is the
        stereo one (mono frames carry no depth). gt_depth_map as in
        track_stereo (mono_airsim.cc)."""
        self.flush_chain()
        self._poll_async_merges()
        if not hasattr(self, "mono_frontend"):
            self.mono_frontend = MonoFrontend(self.cfg, self.height, self.width,
                                              device=self.device)
        with span("frontend", timer=self.stage_timer):
            frame = self.mono_frontend.process(img, timestamp, cost_map, gt_pose, img_name)
        if gt_depth_map is not None:
            frame.kp_gt_depth = sample_gt_depth(gt_depth_map, frame.xy, frame.valid)
        self.current = frame
        with span("track", timer=self.stage_timer):
            self._track_mono_flow()
        return frame.pose

    def _track_mono_flow(self):
        frame = self.current
        if self.state in (State.NO_IMAGES_YET, State.NOT_INITIALIZED):
            self.state = State.NOT_INITIALIZED
            self._monocular_initialization()
            self._record_trajectory(lost=self.state != State.OK)
            self.last_frame = frame
            return
        self._track_after_init()

    def track_rgbd(
        self,
        img: np.ndarray,
        depth_map: np.ndarray,
        timestamp: float,
        depth_scale: float = 1.0,
        img_name: str = "",
    ) -> Optional[np.ndarray]:
        """RGB-D tracking (Tracking::GrabImageRGBD): depth-seeded frames go
        through the stereo state machine. depth_scale turns the map's values
        into metres (1 / DepthMapFactor, examples/run_rgbd.py)."""
        self.flush_chain()
        self._poll_async_merges()
        if not hasattr(self, "rgbd_frontend"):
            self.rgbd_frontend = RGBDFrontend(self.cfg, self.height, self.width,
                                              device=self.device)
        with span("frontend", timer=self.stage_timer):
            frame = self.rgbd_frontend.process(img, depth_map, timestamp, depth_scale,
                                               img_name)
        self.current = frame
        with span("track", timer=self.stage_timer):
            self._track()
        return frame.pose

    # ----------------------------------------------------------- state flow

    def _track(self):
        frame = self.current
        if frame.defer and not (self.cfg.system.fused_tracking and self.state == State.OK
                                and self.velocity is not None and not self.only_tracking):
            frame.materialize()  # only the fused path defers
        if self.state in (State.NO_IMAGES_YET, State.NOT_INITIALIZED):
            self.state = State.NOT_INITIALIZED
            self._stereo_initialization()
            self._record_trajectory(lost=self.state != State.OK)
            self.last_frame = frame
            return
        self._track_after_init()

    def _track_after_init(self):
        frame = self.current
        ok = False
        fused_done = False
        if self.state == State.OK:
            if (self.cfg.system.fused_tracking and self.velocity is not None
                    and not self.only_tracking):
                ok = self._track_fused()
                fused_done = ok  # the fused step ran the local-map stage
            if not ok and self.velocity is not None:
                ok = self._track_with_motion_model()
            if not ok and not fused_done:
                ok = self._track_reference_keyframe()
        elif self.state == State.LOST and self.cfg.system.use_bow:
            ok = self._relocalization()
        if ok and not fused_done:
            ok = self._track_local_map()
        if ok:
            self.state = State.OK
            if self.last_frame is not None and self.last_frame.pose is not None:
                self.velocity = frame.pose @ np.linalg.inv(self.last_frame.pose)
            out = frame.outlier & (frame.map_pt >= 0)
            frame.map_pt[out] = -1
            frame.outlier[:] = False
            if self.only_tracking:
                # drop references to observation-less (VO) points, then the
                # points themselves (Tracking.cc:789-807)
                for i in np.nonzero(frame.map_pt >= 0)[0]:
                    if not self.map.pt_obs[int(frame.map_pt[i])]:
                        frame.map_pt[i] = -1
                self._delete_temporal_points()
            elif self._need_new_keyframe():
                with span("keyframe_event", kf=self.map.n_keyframes, timer=self.stage_timer):
                    self._create_new_keyframe()
            self._record_trajectory(lost=False)
            with span("datagen", timer=self.stage_timer):
                self._run_datagen(frame)
        else:
            self.state = State.LOST
            self._record_trajectory(lost=True)
            self._handle_lost(frame.timestamp)
        self.last_frame = frame

    # ------------------------------------------------------- initialization

    def _stereo_initialization(self):
        frame = self.current
        if frame.n_valid <= 500:
            return
        frame.set_pose(np.eye(4, dtype=np.float32))
        kf_id = self.map.add_keyframe(frame)
        cam = self.cfg.camera
        n_created = 0
        for i in np.nonzero(frame.valid & (frame.depth > 0))[0]:
            pos = frame.unproject_stereo(i, cam.fx, cam.fy, cam.cx, cam.cy)
            qual = frame.qual_score[i] if self.cfg.iv.propagate_keyptqual else 1.0
            pid = self.map.add_point(pos, kf_id, qual)
            self.map.add_observation(pid, kf_id, int(i))
            frame.map_pt[i] = pid
            self.map.compute_distinctive_descriptor(pid)
            self.map.update_normal_and_depth(pid)
            n_created += 1
        if n_created == 0:
            return
        self.local_mapping.insert_keyframe(kf_id)
        self.local_mapping.loop_once(run_ba=False)
        self.ref_kf = kf_id
        frame.ref_kf = kf_id
        self.last_kf_frame_id = frame.frame_id
        self.local_kfs = [kf_id]
        self.local_pts = np.nonzero(self.map.pt_alive[: self.map.n_points])[0]
        self.state = State.OK

    def _monocular_initialization(self):
        """Tracking::MonocularInitialization (951-1150): two frames with
        > 100 features, windowed level-0 matching, the H/F initializer on
        the hypotheses of ``init_sampler``, median-depth normalization
        (CreateInitialMapMonocular), then the first keyframe event."""
        frame = self.current
        prev = self.last_frame
        if prev is None or prev.n_valid <= 100 or frame.n_valid <= 100:
            return
        f = self._f32
        assign, n = match_ops.search_for_initialization(
            prev.kp.xy, prev.kp.octave, prev.kp.angle, prev.kp.desc, prev.kp.valid,
            frame.kp.xy, frame.kp.octave, frame.kp.angle, frame.kp.desc, frame.kp.valid,
            prev.kp.xy, f(100.0), f(0.9 * self.cfg.matcher.nn_ratio_multiplier))
        out = torch.cat([assign, n[None]]).cpu().numpy()
        assign_np, n = out[:-1], int(out[-1])
        if n < 100:
            return
        matched = assign_np >= 0
        p1 = np.where(matched[:, None], prev.xy, 0.0).astype(np.float32)
        p2 = np.where(matched[:, None], frame.xy[np.maximum(assign_np, 0)],
                      0.0).astype(np.float32)
        res = initializer.initialize_mono(
            self._up(p1), self._up(p2), self._up(matched),
            self._up(np.asarray(self.cfg.camera.K(), np.float32)),
            self.init_sampler(frame.frame_id, matched, self.device))
        cap = p1.shape[0]
        flat = torch.cat([res.ok.to(torch.float32)[None], res.R.reshape(9), res.t,
                          res.points.reshape(-1), res.is_good.to(torch.float32)])
        flat = flat.cpu().numpy()
        if flat[0] == 0.0:
            return
        R, t = flat[1:10].reshape(3, 3), flat[10:13]
        pts = flat[13:13 + 3 * cap].reshape(cap, 3)
        good = flat[13 + 3 * cap:] != 0.0
        # median-depth normalization (Tracking::CreateInitialMapMonocular)
        depths = pts[good, 2]
        if len(depths) < 50:
            return
        med = float(np.median(depths))
        if med <= 0:
            return
        inv_med = 1.0 / med
        pts = pts * inv_med
        T2 = np.eye(4, dtype=np.float32)
        T2[:3, :3] = R
        T2[:3, 3] = t * inv_med
        prev.set_pose(np.eye(4, dtype=np.float32))
        frame.set_pose(T2)
        kf0 = self.map.add_keyframe(prev)
        kf1 = self.map.add_keyframe(frame)
        for i in np.nonzero(good & matched)[0]:
            j = int(assign_np[i])
            pid = self.map.add_point(pts[i], kf0)
            self.map.add_observation(pid, kf0, int(i))
            self.map.add_observation(pid, kf1, j)
            prev.map_pt[i] = pid
            frame.map_pt[j] = pid
            self.map.compute_distinctive_descriptor(pid)
            self.map.update_normal_and_depth(pid)
        self.local_mapping.insert_keyframe(kf0)
        self.local_mapping.insert_keyframe(kf1)
        self.local_mapping.loop_once(run_ba=True)
        self.ref_kf = kf1
        frame.ref_kf = kf1
        self.last_kf_frame_id = frame.frame_id
        self.local_pts = np.nonzero(self.map.pt_alive[: self.map.n_points])[0]
        self.state = State.OK

    # ------------------------------------------------------------- tracking

    def _pose_optimize(self, frame: Frame) -> int:
        """The pose LM over the frame's associations, written back as pose,
        outliers and each edge's final chi2 (Optimizer::PoseOptimization;
        the chi2 feeds the unsupervised introspection path,
        Optimizer.cc:452-455, 486-489); one download."""
        has_pt = frame.map_pt >= 0
        if has_pt.sum() < 3:
            return 0
        pids = np.where(has_pt, frame.map_pt, 0)
        obs = np.stack([frame.xy[:, 0], frame.xy[:, 1], frame.u_right], axis=1)
        if self.cfg.iv.propagate_keyptqual:
            qual = self.map.pt_quality[pids].astype(np.float32)
        else:
            qual = frame.qual_score
        res = pose_opt.pose_optimization(
            self._up(frame.pose), self._up(self.map.pt_pos[pids]),
            self._up(obs.astype(np.float32)),
            self._up(self.inv_level_sigma2[frame.octave]),
            self._up(np.asarray(qual, np.float32)), self._up(has_pt), self.K,
            n_rounds=self.cfg.iv.optimizer_pose_opt_iter_count)
        out = torch.cat([res.T.reshape(16), res.inlier.to(torch.float32), res.chi2])
        out = out.cpu().numpy()
        n = has_pt.shape[0]
        frame.set_pose(out[:16].reshape(4, 4))
        inlier = out[16:16 + n] != 0.0
        frame.outlier = has_pt & ~inlier
        frame.chi2 = out[16 + n:]
        frame.chi2_dof = np.where(has_pt, np.where(frame.u_right >= 0, 3, 2), 0).astype(np.int32)
        return int(inlier.sum())

    def _track_fused(self) -> bool:
        """The fused step (slam/fused_track.py): motion search + pose LM +
        full-map local search + pose LM against the device map, one
        download. Falls back to the classic path on failure. A chained
        frame's speculative step is consumed when its inputs are provably
        the ones a fresh dispatch would see: no keyframe pose moved since
        (the re-anchor of _update_last_frame would change nothing) and no
        map event landed (the mirror version: the step read a mirror
        without the event's new, culled or recycled points)."""
        frame = self.current
        last = self.last_frame
        spec = self._spec
        used_spec = (spec is not None and spec["frame"] is frame
                     and spec["ver"] == self.map.poses_ver
                     and spec["mver"] == self._mirror_ver)
        self._used_spec = used_spec
        if not used_spec:
            if last is None or last.pose is None:
                frame.materialize()  # the classic fallback needs the host views
                return False
            self._ensure_fused()
            self._sync_mirror()
            self._update_last_frame()
            T_pred = self.velocity @ last.pose
            with span("fused_dispatch", frame=frame.frame_no, timer=self.stage_timer):
                _res, flat = self._fused.track(frame, last, last.map_pt, T_pred, self._dmap)
        # one download for the step's results and the deferred frame views
        # (a chained frame's copy was started at its dispatch)
        with span("fused_readback", frame=frame.frame_no, timer=self.stage_timer):
            out = self._pulled(spec["pull"]) if used_spec else flat.cpu().numpy()
        n = frame.map_pt.shape[0]
        pack = out[: 10 * n].reshape(n, 10)
        small = out[10 * n:]
        if frame.xy is None:  # deferred frontend views
            frame.xy = np.ascontiguousarray(pack[:, 0:2])
            frame.octave = pack[:, 2].astype(np.int32)
            frame.valid = pack[:, 3] != 0.0
            frame.u_right = np.ascontiguousarray(pack[:, 4])
            frame.depth = np.ascontiguousarray(pack[:, 5])
            frame.qual_score = np.ascontiguousarray(pack[:, 6])
        assign = pack[:, 7].astype(np.int32)
        chi2 = np.ascontiguousarray(pack[:, 9])
        T = small[:16].reshape(4, 4).astype(np.float32)
        n_motion = int(small[16])
        # compaction overflows (never silent): local-search candidates over
        # LOCAL_CAP, pose-LM edges over the compact table
        if small[18] > LOCAL_CAP:
            log.warning("fused local search: %d frustum-gated points > cap %d; "
                        "extras not searched this frame", int(small[18]), LOCAL_CAP)
        if small[19] > 0:
            log.warning("fused pose LM: %d active edges dropped from the compact "
                        "table this frame", int(small[19]))
        if n_motion < 20:
            self._last_fail = (frame.frame_id, "n_motion", n_motion, self.map.n_points)
            return False
        frame.set_pose(T)
        frame.map_pt[:] = assign
        frame.outlier[:] = False
        frame.chi2 = chi2
        frame.chi2_dof = np.where(assign >= 0, np.where(frame.u_right >= 0, 3, 2),
                                  0).astype(np.int32)
        good = assign >= 0
        with self.map.lock:
            self.map.increase_found(assign[good])
            self.n_inliers = int(np.count_nonzero(self.map.pt_n_obs[assign[good]] > 0))
            if self.n_inliers < 30:
                # roll back associations; the classic path retries
                self._last_fail = (frame.frame_id, "n_inliers", self.n_inliers,
                                   self.map.n_points)
                frame.map_pt[:] = -1
                return False
            # reference keyframe: the most-voted observer of the matches
            counter = {}
            for pid in assign[good]:
                for kf_id in self.map.pt_obs[pid]:
                    counter[kf_id] = counter.get(kf_id, 0) + 1
            if counter:
                self.ref_kf = max(counter, key=counter.get)
                frame.ref_kf = self.ref_kf
        self._chain_ok = True  # the fused result was accepted: the chain holds
        return True

    def mark_map_dirty(self):
        self._mark_mirror_stale()

    def _mark_mirror_stale(self):
        """A map event landed: resync the device mirror before the next
        fused step, and void every in-flight speculation (its step read
        rows the event may have recycled)."""
        self._dmap_dirty = True
        self._mirror_ver += 1

    def _update_last_frame(self):
        """Tracking::UpdateLastFrame: refresh the last frame's pose from its
        reference keyframe; in localization-only mode, seed temporary VO
        points from its stereo depths (close points, or the 100 nearest)."""
        last = self.last_frame
        if last.ref_kf >= 0 and self.rel_poses:
            last.set_pose(self.rel_poses[-1] @ self.map.kf_pose[last.ref_kf])
        if (not self.only_tracking or last.frame_id == self.last_kf_frame_id
                or self.cfg.system.sensor == "mono"):
            return
        cam = self.cfg.camera
        order = np.argsort(np.where(last.depth > 0, last.depth, np.inf))
        n_points = 0
        for i in order:
            z = last.depth[i]
            if z <= 0:
                break
            pid = int(last.map_pt[i])
            if pid < 0 or not self.map.pt_obs[pid]:
                pos = last.unproject_stereo(i, cam.fx, cam.fy, cam.cx, cam.cy)
                new_pid = self.map.add_point(pos, -1)
                self.map.pt_desc[new_pid] = last.desc[i]
                last.map_pt[i] = new_pid
                self._temporal_points.append(new_pid)
            n_points += 1
            if z > cam.depth_threshold and n_points > 100:
                break

    def _delete_temporal_points(self):
        for pid in self._temporal_points:
            self.map.kill_point(pid)
        self._temporal_points.clear()

    def _track_with_motion_model(self) -> bool:
        frame = self.current
        last = self.last_frame
        self._update_last_frame()
        frame.set_pose(self.velocity @ last.pose)
        frame.map_pt[:] = -1

        th = 7.0  # stereo (Tracking.cc:1323-1327)
        swm = self.cfg.matcher.search_window_multiplier
        n = self._search_last_frame(th * swm)
        if n < 20:
            frame.map_pt[:] = -1
            n = self._search_last_frame(2 * th * swm)
        if n < 20:
            return False
        self._pose_optimize(frame)
        # discard outlier associations, count map matches (Tracking.cc:1466+)
        return self._discard_outliers(frame) >= 10

    def _search_last_frame(self, th: float) -> int:
        frame = self.current
        last = self.last_frame
        has_pt = (last.map_pt >= 0) & ~last.outlier
        pids = np.where(has_pt, last.map_pt, 0)
        alive = self.map.pt_alive[pids] & has_pt
        cam = self.cfg.camera
        f = self._f32
        assign, n = match_ops.search_by_projection_last_frame(
            frame.kp.xy, frame.kp.octave, frame.kp.angle, frame.kp.desc,
            self._up(np.asarray(frame.u_right, np.float32)), frame.kp.valid,
            self._up(self.map.pt_pos[pids]), self._up(self.map.pt_desc[pids]),
            last.kp.octave, last.kp.angle, self._up(alive),
            self._up(frame.pose), self._up(last.pose),
            f(cam.fx), f(cam.fy), f(cam.cx), f(cam.cy), f(cam.bf), f(cam.baseline),
            f(self.width), f(self.height), self.scale_factors_t, f(th))
        out = torch.cat([assign, n[None]]).cpu().numpy()
        assign, n = out[:-1], int(out[-1])
        matched = assign >= 0
        frame.map_pt[:] = np.where(matched, pids[np.maximum(assign, 0)], -1)
        if self.cfg.iv.propagate_keyptqual:
            self._update_quality_scores(frame)
        return n

    def _update_quality_scores(self, frame: Frame):
        """ORBmatcher::UpdateQualityScores (1108-1146): min-propagate quality
        between matched keypoints and their map points."""
        idx = np.nonzero(frame.map_pt >= 0)[0]
        pids = frame.map_pt[idx]
        mpt_q = self.map.pt_quality[pids]
        updated = np.minimum(mpt_q, frame.qual_score[idx])
        changed = np.abs(updated - mpt_q) > 0.01
        self.map.pt_quality[pids[changed]] = updated[changed]
        self.map.mark_dirty(pids[changed])
        frame.qual_score[idx] = updated

    def _track_reference_keyframe(self) -> bool:
        """Tracking::TrackReferenceKeyFrame (1154-1240). With a vocabulary
        attached and use_bow, the reference's use_BoW=true branch first:
        windowless SearchByBoW against the reference keyframe. Else, or on
        its failure, the use_BoW=false projection variant: a th=5 window
        search from the last pose."""
        frame = self.current
        frame.set_pose(self.last_frame.pose)
        frame.map_pt[:] = -1
        if self.cfg.system.use_bow and getattr(self, "voc", None) is not None:
            if self._track_reference_keyframe_bow():
                return True
            frame.set_pose(self.last_frame.pose)
            frame.map_pt[:] = -1
        swm = self.cfg.matcher.search_window_multiplier
        n = self._search_local_points(th=5.0 * swm,
                                      nn_ratio=0.7 * self.cfg.matcher.nn_ratio_multiplier)
        if n < 15:
            return False
        self._pose_optimize(frame)
        return self._discard_outliers(frame) >= 10

    def _track_reference_keyframe_bow(self) -> bool:
        """SearchByBoW(ref KF, current) -> pose optimization
        (ORBmatcher.cc SearchByBoW + Tracking.cc:1165-1175)."""
        frame = self.current
        rf = self.map.kf_frames[self.ref_kf]
        if rf is None:
            return False
        ref_has = (rf.map_pt >= 0) & rf.valid
        if ref_has.sum() < 15:
            return False
        ref_nodes = self.voc.feature_nodes(rf.desc, rf.valid)
        cur_nodes = self.voc.feature_nodes(frame.desc, frame.valid)
        assign, n = bow_match.search_by_bow(
            rf.kp.desc, self._up(ref_nodes), rf.kp.angle, self._up(ref_has),
            frame.kp.desc, self._up(cur_nodes), frame.kp.angle, frame.kp.valid,
            self._f32(0.7 * self.cfg.matcher.nn_ratio_multiplier))
        out = torch.cat([assign, n[None]]).cpu().numpy()
        assign, n = out[:-1], int(out[-1])
        if n < 15:
            return False
        ai = np.nonzero(assign >= 0)[0]        # reference keyframe features
        frame.map_pt[assign[ai]] = rf.map_pt[ai]
        self._pose_optimize(frame)
        return self._discard_outliers(frame) >= 10

    def _discard_outliers(self, frame: Frame) -> int:
        out = frame.outlier & (frame.map_pt >= 0)
        frame.map_pt[out] = -1
        frame.outlier[out] = False
        good = frame.map_pt >= 0
        # matches to points with observations (in the map)
        return int(np.count_nonzero(self.map.pt_n_obs[frame.map_pt[good]] > 0))

    def _track_local_map(self) -> bool:
        frame = self.current
        self._update_local_map()
        self._search_local_map_points()
        self._pose_optimize(frame)
        # statistics + strip stereo outliers (Tracking.cc:1655-1684)
        good = (frame.map_pt >= 0) & ~frame.outlier
        self.map.increase_found(frame.map_pt[good])
        if self.only_tracking:
            # localization mode counts every non-outlier match
            # (Tracking.cc:1661-1666)
            self.n_inliers = int(good.sum())
        else:
            self.n_inliers = int(np.count_nonzero(self.map.pt_n_obs[frame.map_pt[good]] > 0))
        bad = (frame.map_pt >= 0) & frame.outlier
        frame.map_pt[bad] = -1
        frame.outlier[bad] = False
        return self.n_inliers >= 30

    def _update_local_map(self):
        """UpdateLocalKeyFrames + UpdateLocalPoints (Tracking.cc:2134-2270)."""
        frame = self.current
        counter = {}
        for pid in frame.map_pt[frame.map_pt >= 0]:
            if not self.map.pt_alive[pid]:
                continue
            for kf_id in self.map.pt_obs[pid]:
                counter[kf_id] = counter.get(kf_id, 0) + 1
        if not counter:
            return
        local = sorted(counter, key=counter.get, reverse=True)
        seen = set(local)
        for kf_id in list(local):
            if len(local) > 80:
                break
            for nb, _w in self.map.covisible_keyframes(kf_id)[:10]:
                if nb not in seen:
                    local.append(nb)
                    seen.add(nb)
                    break
        self.local_kfs = local
        best_kf = max(counter, key=counter.get)
        self.ref_kf = best_kf
        frame.ref_kf = best_kf
        pts = set()
        for kf_id in local:
            kf_frame = self.map.kf_frames[kf_id]
            if kf_frame is None:
                continue
            for pid in kf_frame.map_pt[kf_frame.map_pt >= 0]:
                if self.map.pt_alive[pid]:
                    pts.add(int(pid))
        self.local_pts = np.fromiter(pts, np.int64, len(pts))

    def _search_local_map_points(self):
        """SearchLocalPoints (Tracking.cc:2088-2132)."""
        frame = self.current
        self.map.increase_visible(frame.map_pt[frame.map_pt >= 0])
        th = 5.0 if frame.frame_id < 2 else 1.0
        self._search_local_points(th=th * self.cfg.matcher.search_window_multiplier,
                                  nn_ratio=0.8 * self.cfg.matcher.nn_ratio_multiplier,
                                  exclude_current=True)

    def _search_local_points(self, th: float, nn_ratio: float,
                             exclude_current: bool = False) -> int:
        frame = self.current
        pts = self.local_pts
        if pts.size == 0:
            return 0
        cam = self.cfg.camera
        cur_in_frame = set(frame.map_pt[frame.map_pt >= 0].tolist())
        pt_valid = self.map.pt_alive[pts].copy()
        if exclude_current and cur_in_frame:
            pt_valid &= ~np.isin(pts, list(cur_in_frame))
        # the point axis padded to a x4 ladder from 1024 (the reference's
        # bounded set of shapes)
        cap = 1024
        while cap < len(pts):
            cap *= 4
        if cap != len(pts):
            pad = cap - len(pts)
            pts = np.concatenate([pts, np.zeros(pad, pts.dtype)])
            pt_valid = np.concatenate([pt_valid, np.zeros(pad, bool)])
        f = self._f32
        assign, _n = match_ops.search_by_projection_local_map(
            frame.kp.xy, frame.kp.octave, frame.kp.desc,
            self._up(np.asarray(frame.u_right, np.float32)), frame.kp.valid,
            self._up(frame.map_pt >= 0),
            self._up(self.map.pt_pos[pts]), self._up(self.map.pt_desc[pts]),
            self._up(self.map.pt_normal[pts]), self._up(self.map.pt_min_dist[pts]),
            self._up(self.map.pt_max_dist[pts]), self._up(pt_valid),
            self._up(frame.pose),
            f(cam.fx), f(cam.fy), f(cam.cx), f(cam.cy), f(cam.bf),
            f(self.width), f(self.height), self.scale_factors_t, f(self.log_scale),
            f(th), f(nn_ratio))
        assign = assign.cpu().numpy()
        newly = (assign >= 0) & (frame.map_pt < 0)
        frame.map_pt[newly] = pts[assign[newly]]
        return int((frame.map_pt >= 0).sum())

    # ------------------------------------------------------------ keyframes

    def _need_new_keyframe(self) -> bool:
        """Tracking.cc:1694-1772. Under the worker, the reference's
        busy-mapper backpressure: with 3 events still queued the keyframe is
        refused, unless the keyframe gap has reached max_frames and fewer
        than 6 are queued (the reference's starvation guard)."""
        lm = self.local_mapping
        if lm._worker is not None and lm.pending_count() >= 3:
            gap = self.current.frame_id - self.last_kf_frame_id
            if gap < self.max_frames or lm.pending_count() >= 6:
                return False
        frame = self.current
        with self.map.lock:
            n_kfs = self.map.n_keyframes
            n_min_obs = 3 if n_kfs > 2 else 2
            ref_frame = self.map.kf_frames[self.ref_kf]
            n_ref_matches = 0
            if ref_frame is not None:
                pids = ref_frame.map_pt[ref_frame.map_pt >= 0]
                n_ref_matches = int(np.count_nonzero(
                    self.map.pt_alive[pids] & (self.map.pt_n_obs[pids] >= n_min_obs)))
        close = (frame.depth > 0) & (frame.depth < self.cfg.camera.depth_threshold)
        tracked = (frame.map_pt >= 0) & ~frame.outlier
        n_tracked_close = int((close & tracked).sum())
        n_nontracked_close = int((close & ~tracked).sum())
        need_close = (n_tracked_close < 100) and (n_nontracked_close > 70)
        th_ref = 0.75 if n_kfs >= 2 else 0.4
        c1a = frame.frame_id >= self.last_kf_frame_id + self.max_frames
        c1b = frame.frame_id >= self.last_kf_frame_id + self.min_frames
        c1c = (self.n_inliers < n_ref_matches * 0.25) or need_close
        c2 = ((self.n_inliers < n_ref_matches * th_ref) or need_close) and self.n_inliers > 15
        return (c1a or c1b or c1c) and c2

    def _create_new_keyframe(self):
        """Tracking.cc:1774-1860: promote the frame to a keyframe, create its
        close stereo points, then hand the event to the worker or run local
        mapping inline (LoopOnce) and, with loop closing on, LoopClosing on
        the reference keyframe."""
        frame = self.current
        with self.map.lock:
            self._create_new_keyframe_locked(frame)
        run_ba = frame.frame_id % max(self.cfg.iv.tracking_ba_rate, 1) == 0
        if self.local_mapping._worker is not None:
            self.local_mapping.kick_async(run_ba=run_ba)
            return
        self.local_mapping.loop_once(run_ba=run_ba)
        if (self.cfg.system.enable_loop_closing and hasattr(self, "loop_closing")
                and self.map.kf_alive[self.ref_kf]):
            # merge a deferred global BA from an earlier closure before
            # anything else touches the map at this keyframe event (the next
            # keyframe event is the join point of the reference's GBA thread)
            if self.loop_closing.collect_gba():
                self._mark_mirror_stale()
            # join an async local BA before a potential loop correction: a
            # stale merge after CorrectLoop would overwrite the corrected
            # poses (the reference sets mbAbortBA and mbStopGBA,
            # LoopClosing.cc:437-449)
            self.local_mapping.apply_pending_ba()
            if self.loop_closing.process_keyframe(self.ref_kf,
                                                  fix_scale=self.cfg.system.sensor != "mono"):
                self._mark_mirror_stale()

    def _create_new_keyframe_locked(self, frame):
        kf_id = self.map.add_keyframe(frame)
        self.ref_kf = kf_id
        frame.ref_kf = kf_id
        cam = self.cfg.camera
        depth_order = np.argsort(np.where(frame.depth > 0, frame.depth, np.inf))
        # reference loop semantics (Tracking.cc:1795-1850): walk close to
        # far, create points for unassociated features, stop at the first
        # entry past ThDepth once > 100 points are registered; sorted order
        # makes the cutoff computable up front
        z_sorted = frame.depth[depth_order]
        n_pos = int(np.count_nonzero(z_sorted > 0))
        n_close = int(np.count_nonzero((z_sorted > 0) & (z_sorted <= cam.depth_threshold)))
        # the reference processes the first past-ThDepth entry too before its
        # (z > th && n > 100) break fires, hence the +1
        k = min(n_close + 1, n_pos) if n_close > 100 else min(101, n_pos)
        idx = depth_order[:k]
        pids = frame.map_pt[idx]
        create = (pids < 0) | (self.map.pt_n_obs[np.maximum(pids, 0)] == 0)
        ci = idx[create]
        touched = []
        if len(ci):
            Twc = np.linalg.inv(frame.pose)
            z = frame.depth[ci]
            pc = np.stack([(frame.xy[ci, 0] - cam.cx) * z / cam.fx,
                           (frame.xy[ci, 1] - cam.cy) * z / cam.fy, z], axis=1)
            pw = pc @ Twc[:3, :3].T + Twc[:3, 3]
            quals = (frame.qual_score[ci].astype(np.float32)
                     if self.cfg.iv.propagate_keyptqual else 1.0)
            new_pids = self.map.add_points_batch(pw.astype(np.float32), kf_id, quals)
            # fresh points have no prior observations: seed the dicts
            # directly (stereo features weigh 2, mono 1)
            w = np.where(frame.u_right[ci] >= 0, 2, 1)
            obs = self.map.pt_obs
            n_obs = self.map.pt_n_obs
            for pid, i, wi in zip(new_pids, ci, w):
                obs[pid][kf_id] = int(i)
                n_obs[pid] = wi
            frame.map_pt[ci] = new_pids
            touched.extend(new_pids.tolist())
        # register observations of existing tracked points
        for i in np.nonzero(frame.map_pt >= 0)[0]:
            pid = int(frame.map_pt[i])
            if self.map.pt_alive[pid] and kf_id not in self.map.pt_obs[pid]:
                self.map.add_observation(pid, kf_id, int(i))
                touched.append(pid)
        self.map.compute_distinctive_descriptor_batch(touched)
        self.map.update_normal_and_depth_batch(touched)
        self.last_kf_frame_id = frame.frame_id
        self._mark_mirror_stale()
        self.local_mapping.insert_keyframe(kf_id)

    # -------------------------------------------------------- relocalization

    def attach_vocabulary(self, voc):
        """Enable the BoW features: reference-keyframe tracking by BoW and
        relocalization (use_bow), loop closing (enable_loop_closing)."""
        self.voc = voc
        self.kfdb = KeyFrameDatabase(voc)
        self.kf_bow = KeyFrameBow(voc, self.map, self.device)
        self.loop_closing = LoopClosing(self.cfg, self.map, voc, self.kfdb, self.device,
                                        bow=self.kf_bow)

    def _relocalization(self) -> bool:
        """Tracking::Relocalization (2272-2421): BoW candidates -> per-
        candidate BoW matching -> PnP RANSAC -> pose optimization; accept at
        >= 50 inliers. (The IV-SLAM fork resets instead of relocalizing,
        Tracking.cc:829-854, so the reference's loop never reaches this:
        a lost frame resets at once.)"""
        if not hasattr(self, "voc") or self.map.n_keyframes == 0:
            return False
        frame = self.current
        leaf = self.voc.transform_nodes(frame.desc, frame.valid)
        bow = self.voc.bow_vector(frame.desc, nodes=leaf)
        cands = self.kfdb.detect_relocalization_candidates(bow, self.map)
        if not cands:
            return False
        nodes_cur = self.voc.feature_nodes(frame.desc, nodes=leaf)
        cam = self.cfg.camera
        sf2 = self.map.scale_factors ** 2
        for cand in cands[:5]:
            cf = self.map.kf_frames[cand]
            if cf is None:
                continue
            self.kf_bow.ensure(cand)
            assign, n = bow_match.search_by_bow(
                cf.kp.desc, self._up(self.kf_bow.kf_nodes[cand]), cf.kp.angle,
                self._up((cf.map_pt >= 0) & cf.valid),
                frame.kp.desc, self._up(nodes_cur), frame.kp.angle, frame.kp.valid,
                self._f32(0.75))
            out = torch.cat([assign, n[None]]).cpu().numpy()
            assign_np, n = out[:-1], int(out[-1])
            if n < 15:
                continue
            ai = np.nonzero(assign_np >= 0)[0]
            pids = cf.map_pt[ai]
            alive = self.map.pt_alive[pids]
            ai, pids = ai[alive], pids[alive]
            bi = assign_np[ai]
            if len(ai) < 6:
                continue
            cap = frame.xy.shape[0]
            Xw = np.zeros((cap, 3), np.float32)
            uv = np.zeros((cap, 2), np.float32)
            s2 = np.ones(cap, np.float32)
            val = np.zeros(cap, bool)
            Xw[: len(ai)] = self.map.pt_pos[pids]
            uv[: len(ai)] = frame.xy[bi]
            s2[: len(ai)] = sf2[frame.octave[bi]]
            val[: len(ai)] = True
            res = pnp.pnp_ransac(self._up(Xw), self._up(uv), self._up(s2), self._up(val),
                                 cam.fx, cam.fy, cam.cx, cam.cy,
                                 self.pnp_sampler(frame.frame_id, val, self.device))
            out = torch.cat([res.T.reshape(-1), res.ok.to(torch.float32)[None]]).cpu().numpy()
            if out[16] == 0.0:
                continue
            frame.set_pose(out[:16].reshape(4, 4))
            frame.map_pt[:] = -1
            frame.map_pt[bi] = pids
            if self._pose_optimize(frame) >= 50:
                self.state = State.OK
                return True
        return False

    # -------------------------------------------------------- introspection

    def enable_datagen(self, out_path=None):
        from ..introspection.datagen import DataGenerator

        self.datagen = DataGenerator(self.cfg, self.map, out_path, device=self.device)

    def _run_datagen(self, frame):
        """Training-data generation hooks (Tracking.cc:687-775): run after
        pose estimation on OK frames past the warmup."""
        if (self.datagen is None or not self.cfg.iv.enabled or self.cfg.iv.inference_mode
                or frame.frame_id <= 2):
            return
        self.datagen.set_map(self.map)
        img_hw = (self.height, self.width)
        if not self.cfg.iv.unsupervised_learning:
            self.datagen.process_frame_supervised(frame, img_hw, prev_frame=self.last_frame)
            return
        if frame.chi2 is None:
            return
        found = np.where(frame.map_pt >= 0, self.map.pt_found[np.maximum(frame.map_pt, 0)], 0)
        reliable = True
        if frame.gt_pose is not None and self.last_frame is not None:
            from ..introspection import unsupervised as unsup

            ref_kf = self.ref_kf
            if ref_kf >= 0 and self.map.kf_gt_pose[ref_kf] is not None:
                err6 = unsup.relative_pose_error(
                    np.linalg.inv(self.map.kf_pose[ref_kf]), np.linalg.inv(frame.pose),
                    self.map.kf_gt_pose[ref_kf], frame.gt_pose)
                dt = max((frame.frame_id - self.last_kf_frame_id) / max(self.max_frames, 1),
                         1e-3)
                rel_gt = np.linalg.inv(self.map.kf_gt_pose[ref_kf]) @ frame.gt_pose
                reliable = unsup.evaluate_tracking_accuracy(
                    err6, rel_gt, dt, self.cfg.iv.ref_pose_ang_var_inv,
                    self.cfg.iv.ref_pose_trans_var_inv)
        self.datagen.process_frame_unsupervised(frame, frame.chi2, frame.chi2_dof, found,
                                                reliable, img_hw)

    # -------------------------------------------------------------- failure

    def _handle_lost(self, timestamp: float):
        """Tracking.cc:829-854: reset; count failures once initialized maps
        had > 3 keyframes."""
        if self.map.n_keyframes > 3:
            self.failure_count += 1
            self.failure_timestamps.append(timestamp)
            log.warning("tracking LOST at t=%.2f (kfs=%d pts=%d last_fail=%s)",
                        timestamp, self.map.n_keyframes, self.map.n_points,
                        getattr(self, "_last_fail", None))
        self._reset()

    def _reset(self):
        # queued speculations mirror a dead map: strip them but keep the
        # frames, so each is still processed (fresh) and the trajectory
        # has no gap
        for e in self._pendq:
            e.update(res=None, pull=None, ver=-1)
        # drain the worker before discarding the map it is mutating
        try:
            self.local_mapping.join()
        except Exception:
            pass  # a failed event on a map being reset is moot
        self.local_mapping.stop_worker()
        # bake out this sub-session's absolute poses before dropping the map
        # (the reference saves per-sub-session trajectories on each failure,
        # Tracking.cc:2433-2504)
        self._finalized_twc.extend(self._compose_session())
        self._session_start = len(self.rel_poses)
        self.map = MapStore(n_levels=self.cfg.orb.n_levels,
                            scale_factor=self.cfg.orb.scale_factor)
        self.local_mapping = LocalMapping(self.cfg, self.map, self.device)
        # the mirror carries over, resynced from the new map
        self.local_mapping.dmap = self._dmap
        if self.cfg.system.threaded_local_mapping:
            self._setup_threaded_mapping()
        self.state = State.NOT_INITIALIZED
        self.velocity = None
        self.ref_kf = -1
        self.local_kfs = []
        self.local_pts = np.zeros(0, np.int64)
        self._mark_mirror_stale()
        if hasattr(self, "voc"):
            self.attach_vocabulary(self.voc)  # a fresh database for the new map

    # ----------------------------------------------------------- trajectory

    def _record_trajectory(self, lost: bool):
        frame = self.current
        self.frame_times.append(frame.timestamp)
        self.lost_flags.append(lost)
        if lost or frame.pose is None or self.ref_kf < 0:
            self.rel_poses.append(self.rel_poses[-1] if self.rel_poses
                                  else np.eye(4, dtype=np.float32))
            self.rel_refs.append(self.rel_refs[-1] if self.rel_refs else -1)
        else:
            Tcr = frame.pose @ np.linalg.inv(self.map.kf_pose[self.ref_kf])
            self.rel_poses.append(Tcr.astype(np.float32))
            self.rel_refs.append(self.ref_kf)

    def _compose_session(self) -> List[np.ndarray]:
        out = []
        for Tcr, ref in zip(self.rel_poses[self._session_start:],
                            self.rel_refs[self._session_start:]):
            if ref < 0:
                out.append(np.eye(4, dtype=np.float32))
            else:
                Tcw = Tcr @ self.map.kf_pose[ref]
                out.append(np.linalg.inv(Tcw).astype(np.float32))
        return out

    def trajectory_poses(self) -> List[np.ndarray]:
        """Absolute Twc per frame, composed like SaveTrajectoryKITTI
        (System.cc:709-772): Tcw = Tcr * Trw with the current keyframe
        poses."""
        self.flush_chain()
        return self._finalized_twc + self._compose_session()
