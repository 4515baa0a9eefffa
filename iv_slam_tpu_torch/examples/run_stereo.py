"""Stereo SLAM driver — the Examples/Stereo/stereo_kitti.cc equivalent.

Port of the JAX package's ``examples/run_stereo.py``: the same flags (the
reference binary's, stereo_kitti.cc:54-126) and output files
(Trajectory_KITTI_000.txt, KeyFrameTrajectory_TUM_000.txt,
failure_log.txt, stats.json and, with --create_ivslam_dataset, the
training dataset), the stats JSON as the last line of standard output, and
one more flag, --device (cuda unless cpu is asked for). One driver covers
KITTI / EuRoC / Jackal / AirSim via --dataset.

  python -m iv_slam_tpu_torch.examples.run_stereo --dataset kitti \\
      --data_path /data/kitti/00 --settings_path settings/KITTI00-02.yaml \\
      --ground_truth_path /data/kitti/poses/00.txt \\
      --out_visualization_path /tmp/out

The viewer flags draw after each tracked frame, as the reference's driver
does (examples/run_stereo.py:245-380): --enable_viewer saves FrameDrawer's
overlays (frames/) and, every 10th frame, MapDrawer's map (map/);
--live_viewer_port serves both as MJPEG (slam/live_viewer.py) with the
/control menu wired to localization mode and reset; --logging_level >= 1
saves the training-data debug images (introspection/vis.py). Drawing reads
the frame after track_stereo returns and changes nothing the system
computes. --no-run_single_threaded runs the reference's threaded
configuration: keyframe events on the LocalMapping worker thread and the
async local BA (with --real_time_pacing, frames paced at the dataset's
timestamps, as the reference's driver does then). --prewarm starts the
warm-up walk (slam/prewarm.py) and --chained_tracking pipelines the fused
step (slam/tracking.py); both need --fused_tracking.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from . import common


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m iv_slam_tpu_torch.examples.run_stereo")
    p.add_argument("--dataset",
                   choices=["kitti", "euroc", "jackal", "airsim"],
                   default="kitti")
    p.add_argument("--load_gt_depth_imgs", action="store_true",
                   help="load PFM GT depth images (img_depth/*.pfm) and "
                        "sample per-keypoint GT depth "
                        "(stereo_airsim.cc:339-360)")
    p.add_argument("--data_path", required=True)
    p.add_argument("--vocab_path", default="",
                   help="ORB vocabulary (.npz or DBoW2 .txt); enables BoW "
                        "relocalization + loop closing (stereo_kitti.cc "
                        "vocab_path flag)")
    p.add_argument("--settings_path", default="")
    p.add_argument("--ground_truth_path", default="")
    p.add_argument("--img_qual_path", default="",
                   help="precomputed cost-map PNGs (load_img_qual_heatmaps)")
    p.add_argument("--introspection_model_path", default="", help=common.MODEL_HELP)
    p.add_argument("--out_visualization_path", default="out")
    p.add_argument("--out_dataset_path", default="")
    p.add_argument("--start_frame", type=int, default=0)
    p.add_argument("--end_frame", type=int, default=-1)
    p.add_argument("--run_single_threaded",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="inline LoopOnce semantics; --no-run_single_threaded: "
                        "keyframe events on the LocalMapping worker thread "
                        "and the async local BA (System.cc:172-197)")
    p.add_argument("--real_time_pacing", action="store_true",
                   help="pace frames at dataset timestamps (the reference's "
                        "sleep-to-timestamp loop when not single-threaded, "
                        "stereo_kitti.cc:577-585)")
    p.add_argument("--logging_level", type=int, default=0,
                   help=">=1 saves the training-data debug visualizations "
                        "(bad_region_heatmap_vis/, epipolar_err_vec/, ... — "
                        "SaveImagesToFile, Tracking.cc:722-726)")
    p.add_argument("--sync_loader", action="store_true",
                   help="decode images synchronously in the frame loop "
                        "instead of the decode-ahead loader")
    p.add_argument("--create_ivslam_dataset", action="store_true")
    p.add_argument("--ivslam_enabled", action="store_true")
    p.add_argument("--inference_mode", action="store_true")
    p.add_argument("--introspection_func_enabled", action="store_true")
    p.add_argument("--enable_viewer", action="store_true")
    p.add_argument("--live_viewer_port", type=int, default=0,
                   help="serve the frame/map renders live over HTTP "
                        "(MJPEG; the Pangolin-window analogue, "
                        "src/Viewer.cc:56-70). Implies --enable_viewer.")
    p.add_argument("--gt_pose_available", action="store_true")
    p.add_argument("--timestamps_file", default="",
                   help="EuRoC timestamp list")
    p.add_argument("--rel_pose_uncertainty_path", default="",
                   help="per-frame (translational, rotational) uncertainty "
                        "rows (stereo_kitti.cc:73-84)")
    p.add_argument("--load_rel_pose_uncertainty", action="store_true")
    p.add_argument("--profile_stages", action="store_true",
                   help="per-stage wall-clock report (frontend / track / "
                        "keyframe events / local mapping / loop closing / "
                        "datagen) printed at shutdown")
    p.add_argument("--fused_tracking", action="store_true",
                   help="single-dispatch fused tracking step against the "
                        "device-resident map mirror (slam/fused_track.py)")
    p.add_argument("--prewarm", action="store_true",
                   help="warm the fused step's and the keyframe event's device "
                        "work at startup on a background thread "
                        "(slam/prewarm.py; needs --fused_tracking)")
    p.add_argument("--chained_tracking", action="store_true",
                   help="one-frame speculative pipelining of the fused "
                        "step: the step for frame n+1 dispatches "
                        "from frame n's device results; host bookkeeping "
                        "runs one frame behind (needs --fused_tracking)")
    p.add_argument("--rectify_images", action="store_true",
                   help="rectify with the settings' LEFT./RIGHT. blocks "
                        "(stereo_kitti.cc:286-343)")
    common.add_device_flag(p)
    return p.parse_args(argv)


class Viewers:
    """The driver's drawing after each tracked frame (the reference's
    examples/run_stereo.py:245-380): FrameDrawer and, every 10th frame,
    MapDrawer (their PNGs with --enable_viewer, MJPEG with
    --live_viewer_port), and the training-data debug images with
    --logging_level >= 1. It reads the frame after track_stereo returned
    and the host map; it writes nothing the system reads. Host ms of each
    drawer and of the live viewer's encoding are kept for the stats."""

    def __init__(self, args, sys_, seq):
        self.sys, self.seq = sys_, seq
        self.frame_drawer = self.map_drawer = self.live = self.eval_vis = None
        self.draw_ms = {"frame": [], "map": [], "publish": [], "debug": []}
        out = args.out_visualization_path
        if args.enable_viewer or args.live_viewer_port:
            from ..slam.viewer import FrameDrawer, MapDrawer

            save = args.enable_viewer      # live-only mode skips the PNG writes
            self.frame_drawer = FrameDrawer(os.path.join(out, "frames") if save else None)
            self.map_drawer = MapDrawer(os.path.join(out, "map") if save else None)
        if args.live_viewer_port:
            from ..slam.live_viewer import LiveViewer

            self.live = LiveViewer(port=args.live_viewer_port).start()
            # the reference Viewer's menu actions (menuLocalizationMode /
            # menuReset, src/Viewer.cc:101-102 -> 123-141)
            self.live.register_control(
                "localization_mode",
                lambda on: (sys_.activate_localization_mode() if on
                            else sys_.deactivate_localization_mode()))
            self.live.register_control("reset", lambda _v: sys_.reset())
            print(f"live viewer: http://localhost:{self.live.port}/")
        # iLoggingLevel >= 1 -> per-frame heatmap/error-vector debug images
        # (FeatureEvaluator::SaveImagesToFile via Tracking.cc:722-726)
        if args.logging_level >= 1 and sys_.tracking.datagen is not None:
            from ..introspection.vis import FeatureEvalVisualizer

            self.eval_vis = FeatureEvalVisualizer(out)

    def _timed(self, key, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        self.draw_ms[key].append((time.perf_counter() - t0) * 1e3)
        return out

    def after_frame(self, i, left, name):
        s = self.sys
        dg = s.tracking.datagen
        if self.eval_vis is not None and dg.last_result is not None:
            self._timed("debug", self.eval_vis.save_frame, left, name, dg.last_result)
        if self.frame_drawer is None or s.tracking.current is None:
            return
        frame = s.tracking.current
        frame.materialize()
        fvis = self._timed("frame", self.frame_drawer.draw, left, frame, s.state.name)
        mvis = None
        if i % 10 == 0:
            view = self.live.options if self.live is not None else {}
            gt = self.seq.gt_poses
            # the trajectory as it stands (System.trajectory_twc would merge
            # a deferred global BA early, changing what the system computes)
            mvis = self._timed(
                "map", self.map_drawer.draw, s.tracking.map, s.tracking.trajectory_poses(),
                gt_twc=list(gt[: i + 1]) if gt is not None else None, frame_id=i,
                show_points=view.get("show_points", True),
                show_keyframes=view.get("show_keyframes", True),
                show_graph=view.get("show_graph", False),
                follow_camera=view.get("follow_camera", False))
        if self.live is not None:
            m = s.tracking.map
            self._timed("publish", self.live.publish, fvis, mvis, stats=dict(
                frame_id=int(frame.frame_id), state=s.state.name,
                n_keyframes=int(m.kf_alive[: m.n_keyframes].sum()),
                n_points=int(m.pt_alive[: m.n_points].sum()),
                failures=s.failure_count))

    def close(self):
        if self.live is not None:
            self.live.stop()

    def summary(self) -> dict:
        """Median host ms of each drawing step that ran, and its count."""
        return {f"{k}_ms_median": float(np.median(v)) for k, v in self.draw_ms.items() if v} | \
            {f"{k}_calls": len(v) for k, v in self.draw_ms.items() if v}


def make_config(args):
    """The run's Config: the settings YAML, then the flags."""
    from ..config import Config, load_reference_yaml

    cfg = Config()
    if args.settings_path:
        cfg = load_reference_yaml(args.settings_path, cfg)
    cfg.iv.enabled = args.ivslam_enabled
    cfg.iv.inference_mode = args.inference_mode
    cfg.iv.create_dataset = args.create_ivslam_dataset
    cfg.system.fused_tracking = args.fused_tracking
    cfg.system.prewarm = args.prewarm
    cfg.system.single_threaded = args.run_single_threaded
    cfg.system.async_local_ba = not args.run_single_threaded
    # keyframe events (triangulation, fusion, BA, culling, loop closing) on
    # the worker thread: the reference's thread architecture
    cfg.system.threaded_local_mapping = not args.run_single_threaded
    cfg.system.chained_tracking = args.chained_tracking
    return cfg


def load_sequence(args):
    from ..io import datasets

    if args.dataset == "kitti":
        return datasets.load_kitti_stereo(
            args.data_path, args.ground_truth_path or None,
            args.start_frame, args.end_frame)
    if args.dataset == "euroc":
        return datasets.load_euroc_stereo(args.data_path, args.timestamps_file)
    if args.dataset == "airsim":
        return datasets.load_airsim_stereo(
            args.data_path, args.ground_truth_path or None,
            load_gt_depth=args.load_gt_depth_imgs)
    return datasets.load_jackal_session(args.data_path)


def main(argv=None) -> dict:
    """Run the driver; returns the stats it prints and writes."""
    args = parse_args(argv)
    cfg = make_config(args)
    device = common.device_of(args)

    from ..io import datasets, rectify, trajectory
    from ..io.prefetch import StereoPrefetcher
    from ..slam.system import System

    seq = load_sequence(args)

    def gt_depth_for(i):
        paths = getattr(seq, "depth_paths", None)
        if not args.load_gt_depth_imgs or paths is None:
            return None
        return datasets.load_gt_depth_pfm(paths[i])

    # optional stereo rectification from the settings' LEFT./RIGHT. blocks
    rect_maps = (None, None)
    if args.rectify_images and args.settings_path:
        from ..config import _parse_opencv_yaml

        doc = _parse_opencv_yaml(args.settings_path)
        rect_maps = (rectify.load_rectification_from_yaml(doc, "LEFT"),
                     rectify.load_rectification_from_yaml(doc, "RIGHT"))

    class SyncLoader:
        """--sync_loader: decode in the frame loop, as the reference does."""

        def __init__(self):
            self._i = 0

        def next(self):
            i = self._i
            self._i += 1
            left = datasets.load_gray(seq.left_paths[i])
            right = datasets.load_gray(seq.right_paths[i])
            if rect_maps[0] is not None:
                left = rectify.remap(left, rect_maps[0])
            if rect_maps[1] is not None:
                right = rectify.remap(right, rect_maps[1])
            return left, right

        def close(self):
            pass

    left0 = datasets.load_gray(seq.left_paths[0])
    h, w = left0.shape
    cfg.camera.height, cfg.camera.width = h, w
    sys_ = System(cfg, h, w, device=device)

    if args.vocab_path:
        from ..slam.vocabulary import Vocabulary

        sys_.attach_vocabulary(Vocabulary.load(args.vocab_path))

    if args.create_ivslam_dataset:
        cfg.iv.enabled = True
        sys_.enable_datagen(args.out_dataset_path or os.path.join(
            args.out_visualization_path, "generated_training_data"))
        if args.load_rel_pose_uncertainty and args.rel_pose_uncertainty_path:
            unc = np.loadtxt(args.rel_pose_uncertainty_path, delimiter=",", ndmin=2)
            sys_.tracking.datagen.set_rel_pose_uncertainty(
                unc, {n: i for i, n in enumerate(seq.names)})

    # introspection sources: the FCN attached to the frontend (its cost map
    # computed on the device with the frame's extraction), or precomputed
    # heatmap PNGs
    cost_fn = None
    if args.introspection_func_enabled and args.introspection_model_path:
        net, net_hw, cost_fn = common.load_introspection(args.introspection_model_path,
                                                         device)
        if net is not None:
            sys_.tracking.frontend.attach_introspection(net, net_hw)
            cost_fn = None
    elif args.img_qual_path:
        def cost_fn(img, _dir=args.img_qual_path, _seq=seq, _i=[0]):
            name = _seq.names[_i[0]]
            _i[0] += 1
            path = os.path.join(_dir, name)
            return datasets.load_gray(path) if os.path.exists(path) else None

    os.makedirs(args.out_visualization_path, exist_ok=True)

    timer = None
    if args.profile_stages:
        from ..utils import profiling

        # installed: one recorder for Tracking, LocalMapping and LoopClosing
        timer = profiling.StageTimer()
        profiling.install(timer)

    viewer = Viewers(args, sys_, seq)

    t_track = []
    loader = (SyncLoader() if args.sync_loader
              else StereoPrefetcher(seq.left_paths, seq.right_paths, rect_maps=rect_maps))
    with common.flush_on_sigint() as interrupted:
        try:
            # depth-1 frontend prefetch: frame i+1's extraction runs on the
            # device while frame i's tracking occupies the host
            handle = None
            cur_left = None
            if len(seq) > 0:
                left, right = loader.next()
                handle = sys_.submit_frontend(left, right, cost_fn(left) if cost_fn else None)
                cur_left = left
            for i in range(len(seq)):
                if interrupted:
                    print(f"SIGINT at frame {i}: flushing outputs (ShutdownMinimal)")
                    break
                t, gt, name = seq.meta(i)
                t0 = time.perf_counter()
                cur_handle, this_left = handle, cur_left
                if i + 1 < len(seq):
                    nleft, nright = loader.next()
                    handle = sys_.submit_frontend(nleft, nright,
                                                  cost_fn(nleft) if cost_fn else None)
                    cur_left = nleft
                sys_.track_stereo(None, None, t, gt_pose=gt, img_name=name,
                                  frontend_handle=cur_handle, gt_depth_map=gt_depth_for(i))
                t_track.append(time.perf_counter() - t0)
                viewer.after_frame(i, this_left, name)
                if args.real_time_pacing and i + 1 < len(seq):
                    # the reference's sleep(T - ttrack) (stereo_kitti.cc:577-585)
                    budget = float(seq.timestamps[i + 1]) - float(t)
                    if t_track[-1] < budget:
                        time.sleep(budget - t_track[-1])
                if i % 50 == 0:
                    print(f"frame {i}/{len(seq)} state={sys_.state.name} "
                          f"median_track={np.median(t_track):.3f}s")
        finally:
            loader.close()
            viewer.close()

    if args.create_ivslam_dataset and sys_.tracking.datagen is not None:
        sys_.tracking.datagen.finalize()

    out = args.out_visualization_path
    sys_.save_trajectory_kitti(os.path.join(out, "Trajectory_KITTI_000.txt"))
    sys_.save_keyframe_trajectory_tum(os.path.join(out, "KeyFrameTrajectory_TUM_000.txt"))
    sys_.save_failure_log(os.path.join(out, "failure_log.txt"))
    stats = dict(
        frames=len(t_track),
        failures=sys_.failure_count,
        median_track_s=float(np.median(t_track)) if t_track else 0.0,
        mean_track_s=float(np.mean(t_track)) if t_track else 0.0,
        fps=1.0 / float(np.median(t_track)) if t_track else 0.0,
        interrupted=bool(interrupted),
    )
    if seq.gt_poses is not None and not interrupted:
        stats["ate_rmse"] = trajectory.ate_rmse(sys_.trajectory_twc(), list(seq.gt_poses))
    if timer is not None:
        print(timer.report())
        profiling.install(None)
    if any(viewer.draw_ms.values()):
        stats["viewer"] = viewer.summary()
    print(json.dumps(stats))
    with open(os.path.join(out, "stats.json"), "w") as f:
        json.dump(stats, f)
    return stats


if __name__ == "__main__":
    main()
