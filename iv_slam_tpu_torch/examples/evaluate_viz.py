"""Batch-evaluation visualization (evaluate_batch_viz.py parity).

Port of the JAX package's ``examples/evaluate_viz.py``: consumes the
evaluation.json written by evaluate_batch and renders the reference's
comparison figures headless (scripts/evaluation/evaluate_batch_viz.py):
per-session bars of RPE translation, ATE RMSE and failure count for each
mode, sessions sorted by the first mode's failure count (SORT_TRAJ), one
figure with three panels (evaluation.png, 8 x 9 in at 150 dpi) or one a
metric (--separate_graphs: <metric>.png, 8 x 3.2 in). Drawn by
``examples/figures.py`` rather than matplotlib; prints each mode's
aggregate.

  python -m iv_slam_tpu_torch.examples.evaluate_viz --report evaluation.json --out_dir plots
"""

from __future__ import annotations

import argparse
import json
import os

from . import figures

METRICS = (("rpe_trans", "RPE translation (m)"), ("ate_rmse", "ATE RMSE (m)"),
           ("failures", "failure count"))


def main(argv=None) -> dict:
    """Render the figures; returns {file name: each panel's bars}."""
    p = argparse.ArgumentParser(prog="python -m iv_slam_tpu_torch.examples.evaluate_viz")
    p.add_argument("--report", required=True, help="evaluate_batch output")
    p.add_argument("--out_dir", default="eval_plots")
    p.add_argument("--sort_traj", action="store_true", default=True,
                   help="sort sessions by the first mode's failure count")
    p.add_argument("--separate_graphs", action="store_true",
                   help="one figure per metric (SAVE_SEPARATE_GRAPHS)")
    args = p.parse_args(argv)

    with open(args.report) as f:
        report = json.load(f)
    modes = list(report.keys())
    sessions = sorted(k for k in report[modes[0]] if k != "__aggregate__")
    if not sessions:
        raise SystemExit("no sessions in report")
    if args.sort_traj:
        sessions = figures.sessions_by_failures(report, modes, sessions)
    os.makedirs(args.out_dir, exist_ok=True)

    def panel(metric, label):
        return dict(sessions=sessions, modes=modes, title=label,
                    values=figures.values(report, modes, sessions, metric))

    out = {}
    if args.separate_graphs:
        for metric, label in METRICS:
            path = os.path.join(args.out_dir, f"{metric}.png")
            out[f"{metric}.png"] = figures.figure([panel(metric, label)], 1200, 480, path)
            print("wrote", path)
    else:
        path = os.path.join(args.out_dir, "evaluation.png")
        out["evaluation.png"] = figures.figure([panel(m, lab) for m, lab in METRICS], 1200,
                                               1350, path)
        print("wrote", path)

    # aggregate table on stdout (evaluate_batch_postproc's summary role)
    for mode in modes:
        print(mode, json.dumps(report[mode].get("__aggregate__", {})))
    return out


if __name__ == "__main__":
    main()
