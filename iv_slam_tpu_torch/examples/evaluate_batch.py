"""Batch trajectory evaluation (scripts/evaluation/evaluate_batch.py role).

Port of the JAX package's ``examples/evaluate_batch.py``: the reference's
evaluation protocol over a set of sessions, SE3-aligned ATE RMSE and
translational and rotational RPE at a frame or metric delta (evo_ape /
evo_rpe equivalents, evaluate_batch.py:43-55), per-session trajectory
length and failure counts, aggregated per mode (e.g. ORB_SLAM vs IV_SLAM
runs) like evaluate_batch_postproc.py. The same flags and evaluation.json;
--viz writes the evaluate_batch_viz.py figures (rpe_trans.png, rpe_rot.png,
failure_counts.png beside the report), drawn by ``examples/figures.py``
rather than matplotlib.

  python -m iv_slam_tpu_torch.examples.evaluate_batch --results_root results \\
      --gt_root /data/gt --sessions 00019 00020 --modes ORB_SLAM IV_SLAM
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def trajectory_length(poses):
    pts = np.stack([T[:3, 3] for T in poses])
    return float(np.linalg.norm(np.diff(pts, axis=0), axis=1).sum())


def main(argv=None) -> dict:
    """Evaluate; returns the report it prints and writes."""
    p = argparse.ArgumentParser(prog="python -m iv_slam_tpu_torch.examples.evaluate_batch")
    p.add_argument("--results_root", required=True,
                   help="per-mode dirs containing <session>/Trajectory_KITTI_000.txt")
    p.add_argument("--gt_root", required=True,
                   help="per-session GT files <session>.txt (KITTI format)")
    p.add_argument("--modes", nargs="+", default=["ORB_SLAM", "IV_SLAM"])
    p.add_argument("--sessions", nargs="+", required=True)
    p.add_argument("--rpe_delta", type=int, default=1,
                   help="frame delta for RPE")
    p.add_argument("--rpe_delta_m", type=float, default=None,
                   help="metric delta for RPE along the GT path, overriding "
                        "--rpe_delta (the reference's protocol: 2.0 m Jackal "
                        "/ 20 m AirSim / 1 m EuRoC, evaluate_batch.py:43-55)")
    p.add_argument("--viz", action="store_true",
                   help="also render the evaluate_batch_viz.py figures "
                        "(per-session grouped bars, SORT_TRAJ order)")
    p.add_argument("--out", default="evaluation.json")
    args = p.parse_args(argv)

    from ..io import trajectory

    report = {}
    for mode in args.modes:
        report[mode] = {}
        for sess in args.sessions:
            d = os.path.join(args.results_root, mode, sess)
            traj_file = os.path.join(d, "Trajectory_KITTI_000.txt")
            if not os.path.exists(traj_file):
                continue
            est = trajectory.load_kitti(traj_file)
            gt = trajectory.load_kitti(os.path.join(args.gt_root, sess + ".txt"))
            n = min(len(est), len(gt))
            failures = 0
            flog = os.path.join(d, "failure_log.txt")
            if os.path.exists(flog):
                with open(flog) as f:
                    failures = sum(1 for ln in f if ln.strip())
            length = trajectory_length(gt[:n])
            report[mode][sess] = dict(
                ate_rmse=trajectory.ate_rmse(est[:n], gt[:n]),
                rpe_trans=trajectory.rpe(est[:n], gt[:n], args.rpe_delta, "trans",
                                         args.rpe_delta_m),
                rpe_rot_deg=trajectory.rpe(est[:n], gt[:n], args.rpe_delta, "rot",
                                           args.rpe_delta_m),
                failures=failures,
                length_m=length,
                mdbf_m=length / max(failures, 1),  # mean distance between failures
                frames=n,
            )
        vals = report[mode].values()
        if vals:
            report[mode]["__aggregate__"] = dict(
                ate_rmse=float(np.mean([v["ate_rmse"] for v in vals])),
                rpe_trans=float(np.mean([v["rpe_trans"] for v in vals])),
                rpe_rot_deg=float(np.mean([v["rpe_rot_deg"] for v in vals])),
                failures=int(np.sum([v["failures"] for v in vals])),
                total_length_m=float(np.sum([v["length_m"] for v in vals])),
            )
    print(json.dumps(report, indent=2))
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    if args.viz:
        render_viz(report, args.modes, os.path.dirname(args.out) or ".")
    return report


PANELS = (("rpe_trans", "Translational RPE (m, RMSE)", "rpe_trans.png"),
          ("rpe_rot_deg", "Rotational RPE (deg, RMSE)", "rpe_rot.png"),
          ("failures", "Tracking failures per session", "failure_counts.png"))


def render_viz(report, modes, out_dir) -> dict:
    """The evaluate_batch_viz.py figures: per-session grouped bars for
    trans/rot RPE and failure counts, sessions sorted descending by the
    first mode's failure count (SORT_TRAJ, evaluate_batch_viz.py:31-33),
    one measure a figure (7 x 4 in at 150 dpi: 1050 x 600). Returns each
    file's bars."""
    from . import figures

    sessions = figures.sessions_by_failures(report, modes) if modes[0] in report else []
    if not sessions:
        return {}
    out = {}
    for key, title, fname in PANELS:
        path = os.path.join(out_dir, fname)
        out[fname] = figures.figure([dict(sessions=sessions, modes=list(modes), title=title,
                                          values=figures.values(report, modes, sessions, key))],
                                    1050, 600, path)[0]
    return out


if __name__ == "__main__":
    main()
