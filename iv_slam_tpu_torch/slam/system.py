"""System facade (src/System.cc re-designed for one host process).

Port of ``iv_slam_tpu/slam/system.py``: TrackStereo, TrackMonocular,
TrackRGBD, Reset, Shutdown,
SaveTrajectoryKITTI/TUM, SaveKeyFrameTrajectoryTUM, the failure log and the
map's save/load, with local mapping run inline after each keyframe (the
reference's single-threaded mode, System.cc:177-189) or, with
``cfg.system.threaded_local_mapping``, on the LocalMapping worker thread
(System.cc:172-197); ``cfg.system.async_local_ba`` defers the local BA.
``shutdown`` drains the worker and stops it; the trajectory outputs join
it and merge any pending global or local BA first.

``System(cfg, height, width)`` runs on CUDA and raises without it;
``device="cpu"`` runs the plain PyTorch path (the tests).
``attach_vocabulary`` enables BoW tracking, relocalization and loop
closing (``cfg.system.use_bow``, ``enable_loop_closing``); a deferred
global BA merges at the next frame or when the trajectory is read.
``activate_localization_mode`` tracks without mapping.
``enable_datagen`` turns on IV-SLAM's training-data generation
(``cfg.iv.enabled``; supervised from GT poses, or unsupervised).

At construction, with ``cfg.system.link_adaptive`` (the default), System
measures the host<->device round trip once (utils/linkprobe.py; a pinned
``cfg.system.link_rtt_ms`` replaces the measurement) and picks the keyframe
event's program-shape family (``LocalMapping.set_link_profile``: above
``link_rtt_threshold_ms`` the monolithic shapes) before anything runs.
``cfg.system.prewarm`` (with fused tracking) then starts the warm-up walk
(slam/prewarm.py) on a background thread; the trajectory outputs and
``shutdown`` join it and raise its exception, so a failed walk cannot pass
a run. ``cfg.system.chained_tracking`` pipelines the fused step
(slam/tracking.py); the outputs and ``shutdown`` drain the pipeline first.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..config import Config
from ..io import trajectory
from ..utils import linkprobe
from ..utils.profiling import span
from . import prewarm
from .map_store import MapStore
from .tracking import State, Tracking


class System:
    def __init__(self, cfg: Config, height: int, width: int, device=None):
        self.cfg = cfg
        self.tracking = Tracking(cfg, height, width, device=device)
        self._prewarm_thread = None
        # the measured link picks the keyframe event's shape family BEFORE
        # the warm-up walks it
        self.link_rtt_ms = None
        if cfg.system.link_adaptive:
            if cfg.system.link_rtt_ms is not None:
                linkprobe.set_rtt_ms(cfg.system.link_rtt_ms)
            self.link_rtt_ms = linkprobe.probe_rtt_ms(device=self.tracking.device)
            self.tracking.local_mapping.set_link_profile(
                self.link_rtt_ms > cfg.system.link_rtt_threshold_ms)
        if cfg.system.prewarm and cfg.system.fused_tracking:
            self._prewarm_thread = prewarm.prewarm_async(self.tracking)

    # --- tracking entry points (System.h:76-118) ---------------------------

    def track_stereo(
        self,
        img_left: np.ndarray,
        img_right: np.ndarray,
        timestamp: float,
        gt_pose: Optional[np.ndarray] = None,
        gt_cov: Optional[np.ndarray] = None,
        img_name: str = "",
        cost_map: Optional[np.ndarray] = None,
        frontend_handle=None,
        gt_depth_map: Optional[np.ndarray] = None,
    ) -> Optional[np.ndarray]:
        """Returns the camera pose Tcw, or None while not initialized."""
        frame_no = (self.tracking.frontend.next_frame_no if frontend_handle is None
                    else frontend_handle.frame_no)
        with span("system.track", frame=frame_no):
            return self.tracking.track_stereo(
                img_left, img_right, timestamp, cost_map=cost_map, gt_pose=gt_pose,
                gt_cov=gt_cov, img_name=img_name, frontend_handle=frontend_handle,
                gt_depth_map=gt_depth_map)

    def submit_frontend(self, img_left, img_right, cost_map=None):
        """Queue the next frame's frontend, so its device work overlaps the
        host tracking of the current frame. The handle carries the frame's
        ``frame_no``, the id of its spans here and in ``track_stereo``."""
        with span("system.submit", frame=self.tracking.frontend.next_frame_no):
            return self.tracking.submit_frontend(img_left, img_right, cost_map)

    def track_mono(
        self,
        img: np.ndarray,
        timestamp: float,
        gt_pose: Optional[np.ndarray] = None,
        img_name: str = "",
        cost_map: Optional[np.ndarray] = None,
        gt_depth_map: Optional[np.ndarray] = None,
    ) -> Optional[np.ndarray]:
        """Monocular tracking (cfg.system.sensor "mono"); the pose is up to
        the scale fixed at initialization."""
        return self.tracking.track_mono(img, timestamp, cost_map=cost_map, gt_pose=gt_pose,
                                        img_name=img_name, gt_depth_map=gt_depth_map)

    def track_rgbd(
        self,
        img: np.ndarray,
        depth_map: np.ndarray,
        timestamp: float,
        depth_scale: float = 1.0,
        img_name: str = "",
    ) -> Optional[np.ndarray]:
        """RGB-D tracking; depth_map * depth_scale is metric depth."""
        return self.tracking.track_rgbd(img, depth_map, timestamp, depth_scale=depth_scale,
                                        img_name=img_name)

    def attach_vocabulary(self, voc):
        """Enable the BoW features: relocalization and loop closing (the
        reference loads ORBvoc at startup, System.cc:105)."""
        self.tracking.attach_vocabulary(voc)

    def enable_datagen(self, out_path=None):
        """Write IV-SLAM training data (heatmaps, keypoints, descriptors)
        under out_path while tracking; the DataGenerator is
        ``tracking.datagen`` (its ``finalize`` writes the JSON files)."""
        self.tracking.enable_datagen(out_path)

    # --- map persistence ---------------------------------------------------

    def save_map(self, path: str):
        self.tracking.map.save(path)

    def load_map(self, path: str):
        tr = self.tracking
        tr.map = MapStore.load(path, n_levels=self.cfg.orb.n_levels,
                               scale_factor=self.cfg.orb.scale_factor)
        for fr in tr.map.kf_frames[: tr.map.n_keyframes]:
            if fr is not None:   # the keyframes' keypoints onto the tracker's device
                fr.kp = type(fr.kp)(*(t.to(tr.device) for t in fr.kp))
        tr.local_mapping.map = tr.map
        if hasattr(tr, "voc"):
            tr.attach_vocabulary(tr.voc)   # a database for the loaded map
        tr.mark_map_dirty()

    # --- state -------------------------------------------------------------

    @property
    def state(self) -> State:
        return self.tracking.state

    @property
    def failure_count(self) -> int:
        return self.tracking.failure_count

    def activate_localization_mode(self):
        """System::ActivateLocalizationMode (System.h:122): tracking only, no
        keyframes or mapping; temporary VO points carry the motion model."""
        self.tracking.only_tracking = True

    def deactivate_localization_mode(self):
        self.tracking.only_tracking = False

    def reset(self):
        self.tracking._reset()

    def join_prewarm(self):
        """Wait for the warm-up walk; raise what it raised."""
        t = self._prewarm_thread
        if t is None:
            return
        t.join()
        if t.exc is not None:
            raise RuntimeError("the prewarm walk failed") from t.exc

    def _join(self):
        """Join the warm-up walk, drain the tracking pipeline and the
        LocalMapping worker, then merge a deferred global BA and an async
        local BA, so that the outputs compose against the final keyframe
        poses (the reference joins its threads on Shutdown)."""
        tr = self.tracking
        self.join_prewarm()
        tr.flush_chain()
        tr.local_mapping.join()
        lc = getattr(tr, "loop_closing", None)
        if lc is not None and lc.collect_gba():
            tr.mark_map_dirty()
        if tr.local_mapping.apply_pending_ba():
            tr.mark_map_dirty()

    def shutdown(self):
        """Drain the LocalMapping worker and stop it; merge what is
        pending."""
        self._join()
        self.tracking.local_mapping.stop_worker()

    # --- output (System.h:148-163) ------------------------------------------

    def trajectory_twc(self):
        self._join()
        return self.tracking.trajectory_poses()

    def save_trajectory_kitti(self, path: str):
        trajectory.save_kitti(path, self.trajectory_twc())
        trajectory.save_times(os.path.splitext(path)[0] + "_times.txt",
                              self.tracking.frame_times)

    def save_trajectory_tum(self, path: str):
        trajectory.save_tum(path, self.tracking.frame_times, self.trajectory_twc())

    def save_keyframe_trajectory_tum(self, path: str):
        """SaveKeyFrameTrajectoryTUM (System.cc:614-676): keyframe poses
        only, by id, timestamp + Twc quaternion per line."""
        self._join()
        m = self.tracking.map
        times, poses = [], []
        for k in range(m.n_keyframes):
            if not m.kf_alive[k]:
                continue
            times.append(float(m.kf_timestamp[k]))
            poses.append(np.linalg.inv(m.kf_pose[k]))
        trajectory.save_tum(path, times, poses)

    def save_failure_log(self, path: str):
        with open(path, "w") as f:
            for t in self.tracking.failure_timestamps:
                f.write(f"{t:.6f}\n")
