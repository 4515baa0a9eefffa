"""Monocular SLAM driver (Examples/Monocular/mono_{kitti,euroc,tum,airsim}.cc).

Port of the JAX package's ``examples/run_mono.py``: KITTI / EuRoC / TUM /
Jackal / AirSim, precomputed quality heatmaps (mono_airsim img_qual_path),
PFM GT depth (mono_airsim load_gt_depth_imgs), introspection-FCN
inference, and training-data generation; the same flags and output files,
plus --device (cuda unless cpu is asked for).

  python -m iv_slam_tpu_torch.examples.run_mono --dataset kitti \\
      --data_path /data/kitti/00 --settings_path settings/KITTI00-02.yaml
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from . import common


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m iv_slam_tpu_torch.examples.run_mono")
    p.add_argument("--dataset",
                   choices=["kitti", "euroc", "tum", "jackal", "airsim"],
                   default="kitti")
    p.add_argument("--data_path", required=True)
    p.add_argument("--vocab_path", default="",
                   help="ORB vocabulary (.npz or DBoW2 .txt); enables BoW "
                        "relocalization + loop closing")
    p.add_argument("--settings_path", default="")
    p.add_argument("--ground_truth_path", default="")
    p.add_argument("--img_qual_path", default="",
                   help="precomputed cost-map PNGs (mono_airsim "
                        "load_img_qual_heatmaps)")
    p.add_argument("--introspection_model_path", default="", help=common.MODEL_HELP)
    p.add_argument("--introspection_func_enabled", action="store_true")
    p.add_argument("--load_gt_depth_imgs", action="store_true",
                   help="PFM GT depth (img_depth/*.pfm), sampled per "
                        "keypoint (mono_airsim.cc)")
    p.add_argument("--create_ivslam_dataset", action="store_true")
    p.add_argument("--ivslam_enabled", action="store_true")
    p.add_argument("--out_dataset_path", default="")
    p.add_argument("--out_visualization_path", default="out_mono")
    p.add_argument("--start_frame", type=int, default=0)
    p.add_argument("--end_frame", type=int, default=-1)
    p.add_argument("--timestamps_file", default="")
    common.add_device_flag(p)
    return p.parse_args(argv)


def make_config(args):
    from ..config import Config, load_reference_yaml

    cfg = Config()
    if args.settings_path:
        cfg = load_reference_yaml(args.settings_path, cfg)
    cfg.system.sensor = "mono"
    cfg.iv.enabled = args.ivslam_enabled or args.create_ivslam_dataset
    cfg.iv.create_dataset = args.create_ivslam_dataset
    return cfg


def main(argv=None) -> dict:
    """Run the driver; returns the stats it prints and writes."""
    args = parse_args(argv)
    cfg = make_config(args)
    device = common.device_of(args)

    from ..io import datasets, trajectory
    from ..io.prefetch import StereoPrefetcher
    from ..slam.system import System

    if args.dataset == "kitti":
        seq = datasets.load_kitti_stereo(args.data_path, args.ground_truth_path or None,
                                         args.start_frame, args.end_frame)
    elif args.dataset == "euroc":
        seq = datasets.load_euroc_stereo(args.data_path, args.timestamps_file)
    elif args.dataset == "tum":
        seq = datasets.load_tum_mono(args.data_path)
    elif args.dataset == "airsim":
        seq = datasets.load_airsim_stereo(args.data_path, args.ground_truth_path or None,
                                          load_gt_depth=args.load_gt_depth_imgs)
    else:
        seq = datasets.load_jackal_session(args.data_path)

    def gt_depth_for(i):
        paths = getattr(seq, "depth_paths", None)
        if not args.load_gt_depth_imgs or paths is None:
            return None
        return datasets.load_gt_depth_pfm(paths[i])

    left0 = datasets.load_gray(seq.left_paths[0])
    h, w = left0.shape
    cfg.camera.height, cfg.camera.width = h, w
    sys_ = System(cfg, h, w, device=device)
    if args.vocab_path:
        from ..slam.vocabulary import Vocabulary

        sys_.attach_vocabulary(Vocabulary.load(args.vocab_path))
    if args.create_ivslam_dataset:
        sys_.enable_datagen(args.out_dataset_path or os.path.join(
            args.out_visualization_path, "generated_training_data"))

    # introspection sources: FCN checkpoint or precomputed heatmap PNGs
    cost_fn = None
    if args.introspection_func_enabled and args.introspection_model_path:
        _, _, cost_fn = common.load_introspection(args.introspection_model_path, device)
    elif args.img_qual_path:
        def cost_fn(img, _dir=args.img_qual_path, _seq=seq, _i=[0]):
            name = _seq.names[_i[0]]
            _i[0] += 1
            path = os.path.join(_dir, name)
            return datasets.load_gray(path) if os.path.exists(path) else None

    os.makedirs(args.out_visualization_path, exist_ok=True)

    t_track = []
    # decode-ahead loader, right side skipped
    loader = StereoPrefetcher(seq.left_paths, seq.left_paths, right_mode="skip")
    with common.flush_on_sigint() as interrupted:
        try:
            for i in range(len(seq)):
                if interrupted:
                    print(f"SIGINT at frame {i}: flushing outputs")
                    break
                left, _ = loader.next()
                t, gt, name = seq.meta(i)
                t0 = time.perf_counter()
                sys_.track_mono(left, t, gt_pose=gt, img_name=name,
                                cost_map=cost_fn(left) if cost_fn else None,
                                gt_depth_map=gt_depth_for(i))
                t_track.append(time.perf_counter() - t0)
                if i % 50 == 0:
                    print(f"frame {i}/{len(seq)} state={sys_.state.name}")
        finally:
            loader.close()

    if args.create_ivslam_dataset and sys_.tracking.datagen is not None:
        sys_.tracking.datagen.finalize()
    out = args.out_visualization_path
    sys_.save_trajectory_kitti(os.path.join(out, "Trajectory_KITTI_000.txt"))
    sys_.save_keyframe_trajectory_tum(os.path.join(out, "KeyFrameTrajectory_TUM_000.txt"))
    sys_.save_failure_log(os.path.join(out, "failure_log.txt"))
    stats = dict(
        frames=len(t_track), failures=sys_.failure_count,
        median_track_s=float(np.median(t_track)) if t_track else 0.0,
        interrupted=bool(interrupted),
    )
    if seq.gt_poses is not None and not interrupted:
        est = sys_.trajectory_twc()
        if len(est) > 2:
            stats["ate_rmse_sim3"] = trajectory.ate_rmse(
                est, list(seq.gt_poses[: len(est)]), align_scale=True)
    print(json.dumps(stats))
    with open(os.path.join(out, "stats.json"), "w") as f:
        json.dump(stats, f)
    return stats


if __name__ == "__main__":
    main()
