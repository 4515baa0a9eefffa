"""Live streaming SLAM driver — the ROS-node analogue.

Port of the JAX package's ``examples/run_stream.py``. The reference ships
ROS subscriber nodes (Examples/ROS/ORB_SLAM2/src/ros_stereo.cc); the
online contract here is a watched directory: frames are tracked as they
appear (`image_0/*.png` + `image_1/*.png` with matching names), and SIGINT
(or the stream going quiet past --idle_timeout) flushes trajectories and
the failure log as the reference's shutdown handler does
(stereo_kitti.cc:185-196 -> ShutdownMinimal). The same flags, plus
--device (cuda unless cpu is asked for).

  python -m iv_slam_tpu_torch.examples.run_stream --watch_dir /data/live \\
      --settings_path settings/jackal_stereo.yaml --out_path /tmp/live_out
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import time

from . import common


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m iv_slam_tpu_torch.examples.run_stream")
    p.add_argument("--watch_dir", required=True,
                   help="directory with growing image_0/ and image_1/")
    p.add_argument("--settings_path", default="")
    p.add_argument("--vocab_path", default="",
                   help="ORB vocabulary (.npz or DBoW2 .txt); enables "
                        "BoW relocalization + loop closing")
    p.add_argument("--out_path", default="stream_out")
    p.add_argument("--poll_interval", type=float, default=0.02,
                   help="seconds between directory polls")
    p.add_argument("--idle_timeout", type=float, default=0.0,
                   help="stop after this many idle seconds (0 = run until "
                        "SIGINT, like the ROS nodes)")
    p.add_argument("--fps", type=float, default=0.0,
                   help="timestamp synthesis rate when file names are not "
                        "parseable as times (0 = use arrival time)")
    p.add_argument("--fused_tracking", action="store_true")
    common.add_device_flag(p)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the driver until SIGINT or --idle_timeout; returns the stats it
    prints."""
    args = parse_args(argv)
    device = common.device_of(args)
    from ..config import Config, load_reference_yaml
    from ..io import datasets
    from ..slam.system import System

    cfg = Config()
    if args.settings_path:
        cfg = load_reference_yaml(args.settings_path, cfg)
    cfg.system.fused_tracking = args.fused_tracking

    left_dir = os.path.join(args.watch_dir, "image_0")
    right_dir = os.path.join(args.watch_dir, "image_1")
    stop = {"flag": False}

    def on_sigint(_sig, _frm):
        # a second SIGINT exits at once, the first one flushes (ros_stereo)
        if stop["flag"]:
            raise SystemExit(130)
        stop["flag"] = True

    try:
        prev = signal.signal(signal.SIGINT, on_sigint)
    except ValueError:   # not the main thread: no handler
        prev = None
    sys_ = None
    processed = set()
    n_frames = 0
    t_start = time.time()
    last_new = time.time()
    os.makedirs(args.out_path, exist_ok=True)
    try:
        while not stop["flag"]:
            try:
                names = sorted(os.listdir(left_dir))
            except FileNotFoundError:
                names = []
            fresh = [n for n in names if n not in processed
                     and os.path.exists(os.path.join(right_dir, n))]
            if not fresh:
                if args.idle_timeout > 0 and time.time() - last_new > args.idle_timeout:
                    break
                time.sleep(args.poll_interval)
                continue
            for name in fresh:
                left = datasets.load_gray(os.path.join(left_dir, name))
                right = datasets.load_gray(os.path.join(right_dir, name))
                if sys_ is None:
                    h, w = left.shape
                    cfg.camera.height, cfg.camera.width = h, w
                    sys_ = System(cfg, h, w, device=device)
                    if args.vocab_path:
                        from ..slam.vocabulary import Vocabulary

                        sys_.attach_vocabulary(Vocabulary.load(args.vocab_path))
                if args.fps > 0:
                    t = n_frames / args.fps
                else:
                    try:  # TUM-style float-stamp file names
                        t = float(os.path.splitext(name)[0])
                    except ValueError:
                        t = time.time() - t_start
                sys_.track_stereo(left, right, t, img_name=name)
                processed.add(name)
                n_frames += 1
                last_new = time.time()
                if n_frames % 25 == 0:
                    print(f"tracked {n_frames} frames, state={sys_.state.name}", flush=True)
                if stop["flag"]:
                    break
    finally:
        if prev is not None:
            signal.signal(signal.SIGINT, prev)

    stats = dict(frames=n_frames, failures=sys_.failure_count if sys_ is not None else 0)
    if sys_ is not None:
        sys_.save_trajectory_kitti(os.path.join(args.out_path, "Trajectory_KITTI_000.txt"))
        sys_.save_keyframe_trajectory_tum(
            os.path.join(args.out_path, "KeyFrameTrajectory_TUM_000.txt"))
        sys_.save_failure_log(os.path.join(args.out_path, "failure_log.txt"))
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
