"""Every cell's run on the port's CPU path at a tiny size (the harness's
look for a card skipped): its last line meets the run contract, it is
correct, and it comes out not correct when the timed path is broken
underneath. A cell, a configuration, a traffic mix and a per-layer metric
are found by name as new files and entries. On a card, each cell as
committed runs briefly (marked ``cuda``)."""

import json
import os
import shutil
import sys
import time

import pytest
import torch

from portbench.tests.conftest import ROOT, run_cell

CELLS = ("track.kitti_iv_x8", "train.fcn_b8", "costmap.kitti")


def _contract(line, bench, cell, trace):
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(line)[-1] == "checks" and line["checks"]
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}
    dev = line["device"]
    assert dev["count"] == 1 and dev["memory_peak_bytes"] >= 0
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"]: m for m in bench[kind]
             if "workloads" not in m or cell in m["workloads"]}
    assert set(line["metrics"]) <= set(names)
    for k, m in line["metrics"].items():
        assert m["unit"] == names[k]["unit"] and isinstance(m["value"], float)
    if trace:
        assert dev["window_s"] > 0 and dev["busy_s"] > 0
        assert len(line["breakdown"]["device_ops"]) <= 10
        assert len(line["breakdown"]["idle_gaps"]) <= 10
    else:
        assert set(line["metrics"]) == set(names)
        assert all(m["value"] > 0 for m in line["metrics"].values())


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(tiny, cell, trace):
    rc, line = run_cell(tiny, cell, seconds=2.0 if cell.startswith("track") else 0.5,
                        trace=trace)
    assert rc == 0
    _contract(line, json.load(open(os.path.join(tiny, "BENCHMARK.json"))), cell, trace)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0


def test_no_card_no_result(tiny, capsys):
    from portbench import run

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "costmap.kitti", "--seed", "1", "--seconds", "1"], root=tiny)
    assert rc == 3 and capsys.readouterr().out == ""


def test_new_cell_config_traffic_and_metric_are_found_by_name(tiny):
    pb = os.path.join(tiny, "portbench")
    shutil.copy(os.path.join(pb, "configs", "kitti_iv_stereo.json"),
                os.path.join(pb, "configs", "kitti_iv_small.json"))
    wl = json.load(open(os.path.join(pb, "workloads", "costmap.kitti.json")))
    wl["ring_frames"] = 2
    json.dump(wl, open(os.path.join(pb, "workloads", "costmap.kitti_small.json"), "w"))
    with open(os.path.join(pb, "metrics", "frames.costmap_small.py"), "w") as f:
        f.write("def read(data):\n    return float(data['frames'])\n")
    path = os.path.join(tiny, "BENCHMARK.json")
    bench = json.load(open(path))
    bench["configs"].append(dict(name="kitti_iv_small", source="test", reduced=[], why="test",
                                 file="portbench/configs/kitti_iv_small.json"))
    bench["workloads"].append(dict(name="costmap.kitti_small", config="kitti_iv_small",
                                   traffic="ring2", chips=1, why="test"))
    for m in bench["end_to_end"]:
        if m["name"] == "costmap_fps":
            m["workloads"].append("costmap.kitti_small")
    bench["per_layer"].append(dict(name="frames.costmap_small", unit="frames", better="higher",
                                   source="host_clock", layer="test", moves="costmap_fps",
                                   workloads=["costmap.kitti_small"]))
    json.dump(bench, open(path, "w"))
    rc, line = run_cell(tiny, "costmap.kitti_small", seconds=0.3, trace=1)
    assert rc == 0 and line["correct"]
    assert line["metrics"]["frames.costmap_small"]["value"] == line["attempted"]
    rc, line = run_cell(tiny, "costmap.kitti_small", seconds=0.3)
    assert rc == 0 and set(line["metrics"]) == {"costmap_fps", "setup_s"}


# --- faults: the timed path broken underneath --------------------------------

def _wrap(monkeypatch, owner, name, make):
    monkeypatch.setattr(owner, name, make(getattr(owner, name)))


@pytest.mark.parametrize("fault", ["altered", "stale"])
def test_costmap_faults_are_not_correct(tiny, monkeypatch, fault):
    from types import SimpleNamespace

    from iv_slam_tpu_torch import models

    from portbench.drivers import costmap
    from portbench.lib import result, spec

    sp = spec.cell_spec("costmap.kitti", tiny, os.path.join(tiny, "portbench"))
    first = []

    def make(orig):
        def call(*a, **kw):
            out = orig(*a, **kw)
            if fault == "altered":      # one byte of the answer flipped
                out = out.clone()
                out.view(-1)[0] ^= 128
                return out
            first.append(out.clone())   # the first frame's map, every time
            return first[0]
        return call

    _wrap(monkeypatch, models, "inference_cost_map", make)
    torch.set_num_threads(2)
    res = costmap._stream_body(0, 2147483701, sp["config"], sp["workload"], 0.3, False, "cpu",
                               _Parent())
    ctx = SimpleNamespace(workload=sp["workload"], config=sp["config"])
    line = result.build(sp, costmap.aggregate(ctx, [res]), False, 1.0,
                        dict(platform="cpu", kind="cpu", count=1))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_train_faults_are_not_correct(tiny, monkeypatch, fault):
    from iv_slam_tpu_torch.train import train_state

    if fault == "unchanged":            # the step leaves the weights as they were
        monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None: None)
    elif fault == "half_batch":         # half the rows, the mean over the rest
        _wrap(monkeypatch, train_state, "batch_tensors",
              lambda orig: lambda batch, dev, rows=slice(None): orig(
                  batch, dev, slice(0, len(batch["image"]) // 2)))
    else:                               # the loss altered where it is made
        _wrap(monkeypatch, train_state, "deep_sup_loss",
              lambda orig: lambda *a, **kw: tuple(x * 1.05 for x in orig(*a, **kw)))
    rc, line = run_cell(tiny, "train.fcn_b8", seconds=0.3)
    assert rc == 0 and not line["correct"]


class _Parent:
    """The parent's end of a session's pipe: the window starts at once."""

    def send(self, msg):
        pass

    def recv(self):
        return time.time_ns()


@pytest.mark.parametrize("fault", ["altered", "unchanged"])
def test_track_faults_are_not_correct(tiny, monkeypatch, fault):
    from types import SimpleNamespace

    from iv_slam_tpu_torch.slam.system import System

    from portbench.drivers import track
    from portbench.lib import result, spec

    sp = spec.cell_spec("track.kitti_iv_x8", tiny, os.path.join(tiny, "portbench"))
    wl = sp["workload"]
    calls = []

    if fault == "altered":              # one descriptor bit flipped where it is made
        def make(orig):
            def call(self, *a, **kw):
                h = orig(self, *a, **kw)
                h.kl.desc[0, 0] ^= 1
                return h
            return call
        _wrap(monkeypatch, System, "submit_frontend", make)
    else:                               # after the warm-up, tracking does nothing
        def make(orig):
            def call(self, *a, **kw):
                calls.append(1)
                return orig(self, *a, **kw) if len(calls) <= wl["warmup_frames"] else None
            return call
        _wrap(monkeypatch, System, "track_stereo", make)
    torch.set_num_threads(2)
    res = track._session_body(0, 2147483701, sp["config"], wl, 2.0, False, "cpu", _Parent())
    ctx = SimpleNamespace(workload=wl, config=sp["config"])
    line = result.build(sp, track.aggregate(ctx, [res]), False, 1.0,
                        dict(platform="cpu", kind="cpu", count=1))
    assert not line["correct"], line["checks"]


SITECUSTOMIZE = """
import importlib.machinery, os, sys, types
if "--multiprocessing-fork" in sys.orig_argv:
    try:
        fd = os.open(os.path.join(os.path.dirname(__file__), "planted"),
                     os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        pass
    else:                               # the first client alone holds jax
        os.close(fd)
        jax = types.ModuleType("jax")
        jax.__spec__ = importlib.machinery.ModuleSpec("jax", None)
        sys.modules["jax"] = jax
"""


def test_a_session_that_loaded_jax_prints_no_result(tiny, tmp_path, monkeypatch, capfd):
    """One session process of the tracking cell holds jax; the parent does
    not: the run prints no result and names what it found."""
    plant = tmp_path / "plant"
    plant.mkdir()
    (plant / "sitecustomize.py").write_text(SITECUSTOMIZE)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(plant), ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    assert "jax" not in sys.modules
    rc, line = run_cell(tiny, "track.kitti_iv_x8", seconds=1.0)
    assert (plant / "planted").exists()
    assert rc == 4 and line is None
    assert "loaded jax" in capfd.readouterr().err


# --- on the card ---------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(card, cell):
    rc, line = run_cell(ROOT, cell, seconds=3.0, device=None)
    assert rc == 0 and line["correct"], line and line["checks"]
    assert line["device"]["platform"] == "gpu"
