"""AR demo driver — the reference's ros_mono_ar node, headless.

Port of the JAX package's ``examples/run_ar_demo.py``. The reference's AR
demo (Examples/ROS/ORB_SLAM2/src/AR/ros_mono_ar.cc) subscribes to a camera
topic, runs monocular tracking, fits a plane to the map
(ViewerAR::DetectPlane) and renders a virtual cube with the live pose in a
GL window. Here: frames come from a dataset directory (stereo or mono),
tracking runs the same System facade, and the cube/grid overlay is written
per frame to --out_path/ar/ (the headless save-to-file contract), with the
same flags plus --device (cuda unless cpu is asked for).

  python -m iv_slam_tpu_torch.examples.run_ar_demo --data_path <kitti-seq-dir> \\
      --settings_path settings/KITTI00-02.yaml --out_path /tmp/ar
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from . import common


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m iv_slam_tpu_torch.examples.run_ar_demo")
    p.add_argument("--data_path", required=True)
    p.add_argument("--settings_path", default="")
    p.add_argument("--out_path", default="ar_out")
    p.add_argument("--dataset", default="kitti", choices=["kitti", "jackal"])
    p.add_argument("--sensor", default="stereo", choices=["stereo", "mono"])
    p.add_argument("--cube_size", type=float, default=1.0)
    p.add_argument("--min_obs", type=int, default=5,
                   help="observation gate for plane points (ViewerAR uses "
                        ">5; lower for short sequences)")
    p.add_argument("--patience", type=int, default=30,
                   help="frames between automatic gate relaxations")
    p.add_argument("--start_frame", type=int, default=0)
    p.add_argument("--end_frame", type=int, default=-1)
    p.add_argument("--fused_tracking", action="store_true")
    common.add_device_flag(p)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the demo; returns the frames written and whether a plane was
    found."""
    args = parse_args(argv)
    from ..config import Config, load_reference_yaml
    from ..io import datasets
    from ..io.png import write_png
    from ..slam.ar import ARRenderer
    from ..slam.system import System

    device = common.device_of(args)
    cfg = Config()
    if args.settings_path:
        cfg = load_reference_yaml(args.settings_path, cfg)
    cfg.system.sensor = args.sensor
    cfg.system.fused_tracking = args.fused_tracking

    if args.dataset == "kitti":
        seq = datasets.load_kitti_stereo(args.data_path)
    else:
        seq = datasets.load_jackal_session(args.data_path)
    end = args.end_frame if args.end_frame > 0 else len(seq)
    first = datasets.load_gray(seq.left_paths[args.start_frame])
    h, w = first.shape
    cfg.camera.width, cfg.camera.height = w, h
    system = System(cfg, h, w, device=device)
    ar = ARRenderer(cfg.camera.K(), cube_size=args.cube_size, min_obs=args.min_obs,
                    patience=args.patience)

    out_dir = os.path.join(args.out_path, "ar")
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for ni in range(args.start_frame, end):
        left = datasets.load_gray(seq.left_paths[ni])
        t = seq.timestamps[ni]
        if args.sensor == "stereo":
            right = datasets.load_gray(seq.right_paths[ni])
            Tcw = system.track_stereo(left, right, t)
        else:
            Tcw = system.track_mono(left, t)
        frame = ar.render(left, Tcw, system.tracking.map)
        path = os.path.join(out_dir, f"{ni:06d}.png")
        write_png(path, np.ascontiguousarray(frame[..., ::-1]))    # BGR, as cv2.imwrite
        written.append(path)
        if ni % 50 == 0:
            state = "plane" if ar.plane is not None else "searching"
            print(f"frame {ni}: {state}", flush=True)
    system.shutdown()
    print(f"overlays written to {out_dir}")
    return dict(frames=written, plane=ar.plane is not None)


if __name__ == "__main__":
    main()
