"""A tiny copy of the benchmark for CPU rehearsals: the cells' files with
small images, networks, pools and sessions, so that every driver runs on
the port's CPU path in seconds."""

import contextlib
import io
import json
import os
import shutil

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))   # portbench/
ROOT = os.path.dirname(HERE)

TINY = {
    "configs/kitti_iv_stereo.json": {
        "camera": dict(width=320, height=240, fx=300.0, fy=300.0, cx=160.0, cy=120.0,
                       bf=150.0),
        "orb": dict(n_features=800, n_levels=4),
        "net_hw": [64, 64]},
    "configs/fcn_mnv2_c1ds_train.json": {"input_hw": [64, 64], "batch_size": 2},
    "workloads/track.kitti_iv_x8.json": {
        "sessions": 2, "warmup_frames": 3, "check_from": 4, "check_span": 2,
        "world": dict(tex_size=1024, res=30.0),
        "circuit": dict(frames=30, height=10.0, v_min=0.05, v_max=0.25)},
    "workloads/train.fcn_b8.json": {"pool": 8, "warmup_steps": 4},
    "workloads/costmap.kitti.json": {"streams": 2, "ring_frames": 4, "warmup_frames": 1,
                                      "check_frames": 2},
}


def _merge(d, upd):
    for k, v in upd.items():
        if isinstance(v, dict) and isinstance(d.get(k), dict):
            _merge(d[k], v)
        else:
            d[k] = v


def make_tiny(dst: str) -> str:
    """A checkout at dst holding BENCHMARK.json and a tiny portbench/."""
    os.makedirs(dst, exist_ok=True)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(HERE, os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    for rel, upd in TINY.items():
        path = os.path.join(dst, "portbench", rel)
        with open(path) as f:
            d = json.load(f)
        _merge(d, upd)
        with open(path, "w") as f:
            json.dump(d, f)
    return dst


@pytest.fixture
def tiny(tmp_path):
    return make_tiny(str(tmp_path / "checkout"))


def run_cell(root, cell, seed=2147483701, seconds=1.0, trace=0, device="cpu"):
    """(exit code, the last stdout line as an object or None)."""
    import torch

    from portbench import run

    out = io.StringIO()
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with contextlib.redirect_stdout(out):
            rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                           "--trace", str(trace)], root=root, device=device)
    finally:
        torch.set_num_threads(threads)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
