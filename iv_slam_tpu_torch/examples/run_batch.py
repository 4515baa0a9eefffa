"""Batch session runner (scripts/run_stereo_jackal_batch_inference.bash +
run_stereo_jackal_train_data_gen.bash roles).

Port of the JAX package's ``examples/run_batch.py``: runs the port's
run_stereo over a list of sessions, one process each, in one of the
reference's canonical configurations, and lays out results for
evaluate_batch:

  inference:  vanilla tracking (+ optional introspection model)
  datagen:    training-data generation (heatmaps + keypoints datasets)

  python -m iv_slam_tpu_torch.examples.run_batch --mode inference \\
      --sessions_root /data/jackal --sessions 00019 00020 \\
      --settings settings/jackal_stereo.yaml --out results/IV_SLAM \\
      --introspection_model ckpt/best

The same flags, plus --device, handed to each run_stereo.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

from . import common

PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def session_command(args, sess: str) -> list:
    """The run_stereo command line of one session."""
    out_dir = os.path.join(args.out, sess)
    cmd = [
        sys.executable, "-m", "iv_slam_tpu_torch.examples.run_stereo",
        "--dataset", args.dataset,
        "--data_path", os.path.join(args.sessions_root, sess),
        "--settings_path", args.settings,
        "--out_visualization_path", out_dir,
        "--device", args.device,
    ]
    if args.gt_root:
        cmd += ["--ground_truth_path", os.path.join(args.gt_root, sess + ".txt")]
    if args.mode == "datagen":
        cmd += ["--ivslam_enabled", "--create_ivslam_dataset", "--gt_pose_available",
                "--out_dataset_path", os.path.join(out_dir, "generated_training_data")]
    elif args.introspection_model:
        cmd += ["--ivslam_enabled", "--inference_mode", "--introspection_func_enabled",
                "--introspection_model_path", args.introspection_model]
    return cmd


def main(argv=None) -> list:
    """Run every session; returns their exit codes."""
    p = argparse.ArgumentParser(prog="python -m iv_slam_tpu_torch.examples.run_batch")
    p.add_argument("--mode", choices=["inference", "datagen"], required=True)
    p.add_argument("--sessions_root", required=True)
    p.add_argument("--sessions", nargs="+", required=True)
    p.add_argument("--settings", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--dataset", default="jackal")
    p.add_argument("--introspection_model", default="", help=common.MODEL_HELP)
    p.add_argument("--gt_root", default="")
    common.add_device_flag(p)
    args = p.parse_args(argv)
    common.device_of(args)

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [PKG_PARENT] + [v for v in env.get("PYTHONPATH", "").split(os.pathsep) if v])
    rcs = []
    for sess in args.sessions:
        cmd = session_command(args, sess)
        print(">>", " ".join(cmd))
        rc = subprocess.run(cmd, env=env).returncode
        if rc != 0:
            print(f"session {sess} FAILED (rc={rc})")
        rcs.append(rc)
    print("batch complete; evaluate with python -m iv_slam_tpu_torch.examples.evaluate_batch")
    return rcs


if __name__ == "__main__":
    main()
