"""RGB-D SLAM driver (Examples/RGB-D/rgbd_tum.cc).

Port of the JAX package's ``examples/run_rgbd.py``: the same flags and
output files (CameraTrajectory.txt, failure_log.txt, the stats JSON as the
last line of standard output), plus --device (cuda unless cpu is asked
for).

  python -m iv_slam_tpu_torch.examples.run_rgbd --data_path /data/tum/fr1_desk \\
      --association_file /data/tum/fr1_desk/associations.txt \\
      --settings_path settings/TUM1.yaml
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from . import common


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m iv_slam_tpu_torch.examples.run_rgbd")
    p.add_argument("--data_path", required=True)
    p.add_argument("--association_file", required=True)
    p.add_argument("--settings_path", default="")
    p.add_argument("--vocab_path", default="",
                   help="ORB vocabulary (.npz or DBoW2 .txt); enables "
                        "BoW relocalization")
    p.add_argument("--depth_scale", type=float, default=0.0,
                   help="depth-image scale; 0 = 1/DepthMapFactor from the "
                        "settings YAML (TUM PNGs store depth * 5000)")
    p.add_argument("--out_visualization_path", default="out_rgbd")
    common.add_device_flag(p)
    return p.parse_args(argv)


def make_config(args):
    from ..config import Config, load_reference_yaml

    cfg = Config()
    if args.settings_path:
        cfg = load_reference_yaml(args.settings_path, cfg)
    cfg.system.sensor = "rgbd"
    return cfg


def main(argv=None) -> dict:
    """Run the driver; returns the stats it prints."""
    args = parse_args(argv)
    cfg = make_config(args)
    device = common.device_of(args)
    # DepthMapFactor semantics (Tracking.cc YAML parse): depth /= factor
    depth_scale = args.depth_scale
    if depth_scale <= 0.0:
        f = cfg.camera.depth_map_factor
        depth_scale = 1.0 / f if f > 1e-6 else 1.0

    from ..io import datasets
    from ..io.prefetch import StereoPrefetcher
    from ..slam.system import System

    rgb_paths, depth_paths, times = datasets.load_tum_rgbd(args.data_path,
                                                           args.association_file)
    img0 = datasets.load_gray(rgb_paths[0])
    h, w = img0.shape
    cfg.camera.height, cfg.camera.width = h, w
    sys_ = System(cfg, h, w, device=device)
    if args.vocab_path:
        from ..slam.vocabulary import Vocabulary

        sys_.attach_vocabulary(Vocabulary.load(args.vocab_path))

    os.makedirs(args.out_visualization_path, exist_ok=True)

    t_track = []
    # decode-ahead loader: grey RGB + 16-bit depth PNGs decoded off the
    # tracking thread
    loader = StereoPrefetcher(rgb_paths, depth_paths, right_mode="unchanged")
    with common.flush_on_sigint() as interrupted:
        try:
            for i in range(len(rgb_paths)):
                if interrupted:
                    print(f"SIGINT at frame {i}: flushing outputs")
                    break
                img, depth = loader.next()
                depth = np.asarray(depth).astype(np.float32)
                t0 = time.perf_counter()
                sys_.track_rgbd(img, depth, float(times[i]), depth_scale=depth_scale,
                                img_name=os.path.basename(rgb_paths[i]))
                t_track.append(time.perf_counter() - t0)
                if i % 50 == 0:
                    print(f"frame {i}/{len(rgb_paths)} state={sys_.state.name}")
        finally:
            loader.close()

    out = args.out_visualization_path
    sys_.save_trajectory_tum(os.path.join(out, "CameraTrajectory.txt"))
    sys_.save_failure_log(os.path.join(out, "failure_log.txt"))
    stats = dict(frames=len(rgb_paths), failures=sys_.failure_count,
                 median_track_s=float(np.median(t_track)) if t_track else 0.0)
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
