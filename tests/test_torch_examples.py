"""The port's dataset drivers (iv_slam_tpu_torch/examples/) on the CPU.

Each driver runs in process through ``main(argv)`` with ``--device cpu``
on a small layout written here. Held against the JAX package's drivers
(examples/*.py) on the same files and flags:

* run_stereo end to end: the JAX driver's trajectory (classic tracking,
  jitted without FMA contraction, as the System parity tests run it) within
  the System parity tests' pose tolerance, 2e-3; keyframe stamps, failure
  log and frame count exact;
* what each driver hands System (run_stereo, run_mono, run_rgbd,
  run_stream, under several flag sets): System is replaced in each package
  by a recorder, and the Config it is built with (every field), the image
  size, and every call's arguments (images, depth, cost maps, timestamps,
  GT poses, names, datagen paths) are equal, exactly;
* run_batch's session command lines, and evaluate_batch's
  evaluation.json, exactly.

Within the port, exactly: the trajectories of run_stereo, run_mono,
run_rgbd and run_stream equal, byte for byte, those of the port's System
fed the same rendered frames in memory (PNG is lossless); the
identity-rectified run equals the unrectified one byte for byte;
eval_introspection's retention curve equals the JAX package's dataset and
curve functions' exactly, its cost maps equal the port's
inference_cost_map (itself held against JAX in test_torch_fcn.py), its
eval loss the port's eval_loss. Mono and RGB-D are not run end to end
against the JAX drivers: test_torch_mono_rgbd.py holds the two Systems
against each other, and the recorder holds the drivers' inputs.
The viewer flags (--enable_viewer, --live_viewer_port, --logging_level)
leave run_stereo's trajectory bit-equal and draw what the reference's driver
draws; evaluate_batch --viz writes the reference's figures.
--no-run_single_threaded (the LocalMapping worker) runs and tracks as the
single-threaded run; --prewarm and --chained_tracking (with
--fused_tracking) each write the trajectory of the run without them,
within 2e-3; no driver runs on the CPU unless asked.
"""

import dataclasses
import inspect
import json
import os
import runpy
import shutil
import signal
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import synth_world
from iv_slam_tpu.train import data as jdata
from iv_slam_tpu_torch.config import load_reference_yaml
from iv_slam_tpu_torch.examples import (eval_introspection, evaluate_batch, run_batch,
                                        run_mono, run_rgbd, run_stereo, run_stream)
from iv_slam_tpu_torch.io import trajectory
from iv_slam_tpu_torch.io.png import read_png, write_png
from iv_slam_tpu_torch.models.introspection import inference_cost_map
from iv_slam_tpu_torch.slam.system import System
from iv_slam_tpu_torch.train.data import ImageQualityDataset
from iv_slam_tpu_torch.train.train_state import eval_loss
from iv_slam_tpu_torch.train.trainer import TrainConfig, build_net
from test_torch_train_data import dataset  # noqa: F401
from torch_parity import NO_FMA_FLAG, mono_rgbd_world, one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.usefixtures("one_thread")

N_FRAMES = 12
SETTINGS = """%YAML:1.0
Camera.fx: 400.0
Camera.fy: 400.0
Camera.cx: 160.0
Camera.cy: 120.0
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 320
Camera.height: 240
Camera.fps: 10.0
Camera.bf: 200.0
ThDepth: 35.0
DepthMapFactor: 5000.0
ORBextractor.nFeatures: 800
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def _identity_blocks():
    K = [400.0, 0.0, 160.0, 0.0, 400.0, 120.0, 0.0, 0.0, 1.0]
    P = K[:3] + [0.0] + K[3:6] + [0.0] + K[6:] + [0.0]
    out = ""
    for side in ("LEFT", "RIGHT"):
        out += f"{side}.height: 240\n{side}.width: 320\n"
        for name, rows, cols, data in (("D", 1, 5, [0.0] * 5), ("K", 3, 3, K),
                                       ("R", 3, 3, np.eye(3).ravel().tolist()),
                                       ("P", 3, 4, P)):
            out += (f"{side}.{name}: !!opencv-matrix\n   rows: {rows}\n   cols: {cols}\n"
                    f"   dt: d\n   data: [{', '.join(str(v) for v in data)}]\n")
    return out


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    """A 12-frame 320x240 KITTI layout of tests/synth_world.py's sequence
    (every row Paeth-filtered), GT poses relative to the first camera, a
    settings YAML with identity LEFT./RIGHT. rectification blocks, and
    run_stereo's output over it."""
    root = tmp_path_factory.mktemp("kitti")
    seq = root / "00"
    for d in ("image_0", "image_1"):
        (seq / d).mkdir(parents=True)
    _, frames, gt = synth_world.make_sequence(np.random.default_rng(7), n_frames=N_FRAMES)
    for i, (left, right) in enumerate(frames):
        write_png(str(seq / "image_0" / f"{i:06d}.png"), left, filter_type=4)
        write_png(str(seq / "image_1" / f"{i:06d}.png"), right, filter_type=4)
    (seq / "times.txt").write_text("".join(f"{0.1 * i!r}\n" for i in range(N_FRAMES)))
    inv0 = np.linalg.inv(gt[0])
    np.savetxt(root / "00.txt", np.stack([(inv0 @ T)[:3, :4].reshape(-1) for T in gt]),
               fmt="%.9g")
    (root / "settings.yaml").write_text(SETTINGS + _identity_blocks())
    out = root / "out"
    argv = ["--data_path", str(seq), "--settings_path", str(root / "settings.yaml"),
            "--ground_truth_path", str(root / "00.txt"), "--out_visualization_path",
            str(out), "--profile_stages", "--device", "cpu"]
    stats = run_stereo.main(argv)
    return dict(root=root, seq=seq, frames=frames, out=out, stats=stats, argv=argv)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_run_stereo_matches_system(kitti):
    out, stats = kitti["out"], kitti["stats"]
    for f in ("Trajectory_KITTI_000.txt", "KeyFrameTrajectory_TUM_000.txt",
              "failure_log.txt", "stats.json"):
        assert (out / f).exists(), f
    assert stats["frames"] == N_FRAMES and stats["failures"] == 0
    assert stats["ate_rmse"] < 0.5
    assert json.loads((out / "stats.json").read_text()) == stats
    cfg = run_stereo.make_config(run_stereo.parse_args(kitti["argv"]))
    s = System(cfg, 240, 320, device="cpu")
    for i, (left, right) in enumerate(kitti["frames"]):
        s.track_stereo(left, right, 0.1 * i, img_name=f"{i:06d}.png")
    s.save_trajectory_kitti(str(kitti["root"] / "mem.txt"))
    s.save_keyframe_trajectory_tum(str(kitti["root"] / "mem_kf.txt"))
    assert _read(out / "Trajectory_KITTI_000.txt") == _read(kitti["root"] / "mem.txt")
    assert _read(out / "KeyFrameTrajectory_TUM_000.txt") == _read(kitti["root"] / "mem_kf.txt")


def test_run_stereo_matches_jax_driver(kitti, tmp_path):
    """The JAX package's examples/run_stereo.py on the same layout and
    flags, in a JAX process (CPU, no FMA contraction)."""
    out = tmp_path / "jax"
    argv = [a if a != str(kitti["out"]) else str(out) for a in kitti["argv"][:-2]]
    env = dict(os.environ, JAX_PLATFORMS="cpu", IVT_FAST_COMPILE="1",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " " + NO_FMA_FLAG).strip())
    proc = subprocess.run([sys.executable, os.path.join(REPO, "examples", "run_stereo.py"),
                           *argv], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    port = kitti["out"]
    want, got = (json.loads((d / "stats.json").read_text()) for d in (out, port))
    assert (got["frames"], got["failures"]) == (want["frames"], want["failures"])
    assert abs(got["ate_rmse"] - want["ate_rmse"]) < 2e-3
    np.testing.assert_allclose(np.loadtxt(port / "Trajectory_KITTI_000.txt"),
                               np.loadtxt(out / "Trajectory_KITTI_000.txt"), rtol=0, atol=2e-3)
    kf_got, kf_want = (np.loadtxt(d / "KeyFrameTrajectory_TUM_000.txt", ndmin=2)
                       for d in (port, out))
    np.testing.assert_array_equal(kf_got[:, 0], kf_want[:, 0])
    np.testing.assert_allclose(kf_got[:, 1:], kf_want[:, 1:], rtol=0, atol=2e-3)
    assert _read(port / "failure_log.txt") == _read(out / "failure_log.txt")


def test_identity_rectification_is_bit_identical(kitti):
    """--rectify_images with identity blocks (and the in-loop decoding of
    --sync_loader) gives the unrectified run's trajectory, byte for byte."""
    out = kitti["root"] / "rect"
    argv = [a if a != str(kitti["out"]) else str(out) for a in kitti["argv"]]
    stats = run_stereo.main(argv + ["--rectify_images", "--sync_loader"])
    assert stats["frames"] == N_FRAMES
    assert _read(out / "Trajectory_KITTI_000.txt") == \
        _read(kitti["out"] / "Trajectory_KITTI_000.txt")


def test_threaded_run_stereo(kitti):
    """--no-run_single_threaded (the LocalMapping worker and the async local
    BA) over the same layout: no failure, the single-threaded run's
    keyframe stamps, and its trajectory within the System parity tests'
    2e-3."""
    out = kitti["root"] / "threaded"
    argv = [a if a != str(kitti["out"]) else str(out) for a in kitti["argv"]]
    stats = run_stereo.main(argv + ["--no-run_single_threaded"])
    assert stats["frames"] == N_FRAMES and stats["failures"] == 0
    assert abs(stats["ate_rmse"] - kitti["stats"]["ate_rmse"]) < 2e-3
    np.testing.assert_allclose(np.loadtxt(out / "Trajectory_KITTI_000.txt"),
                               np.loadtxt(kitti["out"] / "Trajectory_KITTI_000.txt"),
                               rtol=0, atol=2e-3)
    kf, kf_single = (np.loadtxt(d / "KeyFrameTrajectory_TUM_000.txt", ndmin=2)
                     for d in (out, kitti["out"]))
    np.testing.assert_array_equal(kf[:, 0], kf_single[:, 0])


@pytest.fixture(scope="module")
def fused_run(kitti):
    """run_stereo --fused_tracking over the layout: the run the pipeline
    flags are held against."""
    out = kitti["root"] / "fused"
    argv = [a if a != str(kitti["out"]) else str(out) for a in kitti["argv"]]
    stats = run_stereo.main(argv + ["--fused_tracking"])
    return out, stats


@pytest.mark.parametrize("flags", [["--prewarm"], ["--chained_tracking"]])
def test_pipeline_flags_run(kitti, fused_run, monkeypatch, flags):
    """--prewarm (the warm-up walk, here at its smallest rungs: the full
    ladder is minutes of CPU time) and --chained_tracking, with
    --fused_tracking: no failure, every output, the trajectory within 2e-3
    of the run without the flag and its keyframe stamps."""
    from iv_slam_tpu_torch.slam import prewarm
    from iv_slam_tpu_torch.solvers.local_ba import LBA_RUNGS

    walk = prewarm.prewarm_async
    monkeypatch.setattr(prewarm, "prewarm_async", lambda tr: walk(
        tr, live_rungs=[1024], fuse_shapes=[(16, 1024)], ba_rungs=[LBA_RUNGS[0]]))
    base, base_stats = fused_run
    out = kitti["root"] / flags[0][2:]
    argv = [a if a != str(kitti["out"]) else str(out) for a in kitti["argv"]]
    stats = run_stereo.main(argv + ["--fused_tracking", *flags])
    assert stats["frames"] == N_FRAMES and stats["failures"] == 0 == base_stats["failures"]
    assert abs(stats["ate_rmse"] - base_stats["ate_rmse"]) < 2e-3
    np.testing.assert_allclose(np.loadtxt(out / "Trajectory_KITTI_000.txt"),
                               np.loadtxt(base / "Trajectory_KITTI_000.txt"), rtol=0, atol=2e-3)
    kf, kf_base = (np.loadtxt(d / "KeyFrameTrajectory_TUM_000.txt", ndmin=2)
                   for d in (out, base))
    np.testing.assert_array_equal(kf[:, 0], kf_base[:, 0])


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mjpeg_parts(port, path, n, out, timeout=60.0):
    """A client: read `n` JPEG parts of the live viewer's `path`, retrying
    until the server is up; appends the parts to `out`."""
    import time
    import urllib.request

    end = time.monotonic() + timeout
    while time.monotonic() < end:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
                while len(out) < n:
                    assert r.readline().strip() == b"--ivframe"
                    head = {}
                    while (line := r.readline().strip()):
                        k, v = line.decode().split(":", 1)
                        head[k.strip().lower()] = v.strip()
                    out.append(r.read(int(head["content-length"])))
                    r.readline()
            return
        except OSError:
            time.sleep(0.05)


@pytest.mark.parametrize("flags", [["--enable_viewer"], ["--live_viewer_port"],
                                   ["--logging_level", "1", "--create_ivslam_dataset"]],
                         ids=["enable_viewer", "live_viewer_port", "logging_level"])
def test_viewer_flags_keep_the_trajectory(kitti, tmp_path, flags):
    """Each viewer flag draws what the reference's driver draws and leaves
    the trajectory bit-equal to the run without it: --enable_viewer writes
    one frame overlay a frame and the map every 10th; --live_viewer_port
    streams MJPEG parts that decode to the frame's size; --logging_level 1
    (with training-data generation) writes decodable debug JPEGs."""
    import threading

    from iv_slam_tpu_torch.io import jpeg

    out = tmp_path / "out"
    argv = [a if a != str(kitti["out"]) else str(out) for a in kitti["argv"]]
    parts = []
    if flags == ["--live_viewer_port"]:
        port = _free_port()
        flags = ["--live_viewer_port", str(port)]
        client = threading.Thread(target=_mjpeg_parts, args=(port, "/frame.mjpg", 2, parts),
                                  daemon=True)
        client.start()
    stats = run_stereo.main(argv + flags)
    assert stats["frames"] == N_FRAMES and stats["failures"] == 0
    assert _read(out / "Trajectory_KITTI_000.txt") == \
        _read(kitti["out"] / "Trajectory_KITTI_000.txt")
    if flags == ["--enable_viewer"]:
        frames = sorted(os.listdir(out / "frames"))
        assert frames == [f"frame_{i:06d}.png" for i in range(N_FRAMES)]
        assert sorted(os.listdir(out / "map")) == ["map_000000.png", "map_000010.png"]
        assert read_png(str(out / "frames" / frames[-1])).shape == (240, 320, 3)
        assert read_png(str(out / "map" / "map_000010.png")).shape == (800, 800, 3)
    elif flags[0] == "--live_viewer_port":
        client.join(timeout=30)
        assert len(parts) == 2
        for p in parts:
            assert jpeg.decode(p, "bgr").shape == (240, 320, 3)
        assert stats["viewer"]["publish_calls"] == N_FRAMES
    else:
        names = sorted(os.listdir(out / "epipolar_err_vec"))
        assert names and sorted(os.listdir(out / "bad_region_heatmap_vis")) == names
        for n in names:
            assert jpeg.read_jpeg(str(out / "epipolar_err_vec" / n), "bgr").shape == (240, 320, 3)
        assert stats["viewer"]["debug_calls"] == len(names)


def test_evaluate_batch_viz(tmp_path):
    """--viz writes the reference's three figures beside evaluation.json:
    sessions in SORT_TRAJ order (the first mode's failures, most first),
    a bar a mode and session, each bar's pixel height its value over the
    panel's top value within 1 px."""
    from iv_slam_tpu_torch.examples import figures

    rng = np.random.default_rng(12)
    fails = {"s1": (1, 3), "s2": (4, 0), "s3": (2, 2)}
    for sess, ks in fails.items():
        gt = _trajectories(rng, 12)
        trajectory.save_kitti(str(tmp_path / f"{sess}.txt"), gt)
        for mode, k in zip(("ORB_SLAM", "IV_SLAM"), ks):
            d = tmp_path / "res" / mode / sess
            d.mkdir(parents=True)
            est = [T.copy() for T in gt]
            for T in est:
                T[:3, 3] += rng.normal(0, 0.05, 3)
            trajectory.save_kitti(str(d / "Trajectory_KITTI_000.txt"), est)
            (d / "failure_log.txt").write_text("1.0\n" * k)
    out = tmp_path / "eval" / "evaluation.json"
    out.parent.mkdir()
    report = evaluate_batch.main(["--results_root", str(tmp_path / "res"), "--gt_root",
                                  str(tmp_path), "--sessions", "s1", "s2", "s3", "--viz",
                                  "--out", str(out)])
    names = ("rpe_trans.png", "rpe_rot.png", "failure_counts.png")
    assert sorted(os.listdir(out.parent)) == sorted(names + ("evaluation.json",))
    bars = evaluate_batch.render_viz(report, ["ORB_SLAM", "IV_SLAM"], str(tmp_path))
    plot_h = 600 - figures.TOP - figures.BOTTOM
    for (key, _, fname) in evaluate_batch.PANELS:
        img = read_png(str(out.parent / fname))[..., ::-1]            # BGR
        assert img.shape == (600, 1050, 3)
        got = bars[fname]
        assert [b["session"] for b in got[::2]] == ["s2", "s3", "s1"]
        assert [b["mode"] for b in got[:2]] == ["ORB_SLAM", "IV_SLAM"]
        top = figures._nice_top(max(b["value"] for b in got))
        for b in got:
            assert b["value"] == report[b["mode"]][b["session"]][key]
            col = img[:, (b["x0"] + b["x1"]) // 2]
            color = figures.SERIES[["ORB_SLAM", "IV_SLAM"].index(b["mode"])]
            height = int((col == color).all(-1).sum())
            assert abs(height - b["value"] / top * plot_h) <= 1, (fname, b, height)


@pytest.mark.parametrize("separate", [False, True], ids=["one_figure", "separate_graphs"])
def test_evaluate_viz(tmp_path, separate):
    """evaluate_viz writes the JAX driver's files (evaluation.png, or one
    <metric>.png a metric), sessions sorted by the first mode's failures,
    each bar's pixel height its value over the panel's top within 1 px."""
    from iv_slam_tpu_torch.examples import evaluate_viz, figures

    report = {"ORB_SLAM": {"s1": dict(rpe_trans=0.2, ate_rmse=1.5, failures=1),
                           "s2": dict(rpe_trans=0.05, ate_rmse=0.4, failures=3),
                           "__aggregate__": dict(failures=4)},
              "IV_SLAM": {"s1": dict(rpe_trans=0.1, ate_rmse=0.9, failures=0),
                          "s2": dict(rpe_trans=0.04, ate_rmse=0.3, failures=1)}}
    path = tmp_path / "evaluation.json"
    path.write_text(json.dumps(report))
    out = tmp_path / "plots"
    bars = evaluate_viz.main(["--report", str(path), "--out_dir", str(out)]
                             + (["--separate_graphs"] if separate else []))
    want = ([f"{m}.png" for m, _ in evaluate_viz.METRICS] if separate else ["evaluation.png"])
    assert sorted(os.listdir(out)) == sorted(want)
    for fname, panels in bars.items():
        img = read_png(str(out / fname))[..., ::-1]
        panel_h = img.shape[0] // len(panels)
        for (metric, _), got in zip(evaluate_viz.METRICS if not separate else
                                    [m for m in evaluate_viz.METRICS if f"{m[0]}.png" == fname],
                                    panels):
            assert [b["session"] for b in got[::2]] == ["s2", "s1"]
            top = figures._nice_top(max(b["value"] for b in got))
            for b in got:
                assert b["value"] == report[b["mode"]][b["session"]][metric]
                col = img[b["top"] - 2:b["bottom"] + 2, (b["x0"] + b["x1"]) // 2]
                color = figures.SERIES[["ORB_SLAM", "IV_SLAM"].index(b["mode"])]
                height = int((col == color).all(-1).sum())
                plot_h = panel_h - figures.TOP - figures.BOTTOM
                assert abs(height - b["value"] / top * plot_h) <= 1, (fname, b, height)


def test_run_ar_demo(kitti, tmp_path):
    """The AR demo over the KITTI layout: an overlay PNG a frame at the
    image's size; once the plane is found, the cube's coloured lines are
    drawn on the grey frame."""
    from iv_slam_tpu_torch.examples import run_ar_demo

    res = run_ar_demo.main(["--data_path", str(kitti["seq"]), "--settings_path",
                            str(kitti["root"] / "settings.yaml"), "--out_path", str(tmp_path),
                            "--min_obs", "0", "--device", "cpu"])
    assert [os.path.basename(p) for p in res["frames"]] == [f"{i:06d}.png" for i in
                                                            range(N_FRAMES)]
    last = read_png(res["frames"][-1])
    assert last.shape == (240, 320, 3)
    assert res["plane"]
    assert (last[..., 0] != last[..., 1]).any()        # colour drawn on grey


@pytest.mark.parametrize("mod,argv", [
    (run_stereo, ["--data_path", "x"]), (run_mono, ["--data_path", "x"]),
    (run_rgbd, ["--data_path", "x", "--association_file", "y"]),
    (run_stream, ["--watch_dir", "x"]),
    (run_batch, ["--mode", "inference", "--sessions_root", "x", "--sessions", "a",
                 "--settings", "s", "--out", "o"]),
    (eval_introspection, ["--mode", "eval", "--ckpt", "x"])])
def test_drivers_need_cuda(mod, argv):
    """Without --device cpu a driver runs on the card, or raises: it never
    falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)


@pytest.fixture(scope="module")
def tum(tmp_path_factory):
    """8 frames of tests/test_mono_rgbd.py's world as a TUM mono layout
    (colour PNGs, rgb.txt) and a TUM RGB-D layout (16-bit depth at 5000 a
    metre, associations)."""
    imgs, depths, _ = mono_rgbd_world(8)
    root = tmp_path_factory.mktemp("tum")
    (root / "rgb").mkdir()
    (root / "depth").mkdir()
    stamps = [1305031102.0 + i / 30.0 for i in range(len(imgs))]
    depth_u16 = [np.round(d * 5000.0).astype(np.uint16) for d in depths]
    for i, img in enumerate(imgs):
        write_png(str(root / "rgb" / f"{i:04d}.png"), np.repeat(img[..., None], 3, -1),
                  filter_type=i % 5)
        write_png(str(root / "depth" / f"{i:04d}.png"), depth_u16[i], filter_type=4)
    (root / "rgb.txt").write_text("# rgb\n" + "".join(
        f"{t!r} rgb/{i:04d}.png\n" for i, t in enumerate(stamps)))
    (root / "assoc.txt").write_text("".join(
        f"{t!r} rgb/{i:04d}.png {t!r} depth/{i:04d}.png\n" for i, t in enumerate(stamps)))
    (root / "settings.yaml").write_text(SETTINGS)
    return dict(root=root, imgs=imgs, depth=depth_u16, stamps=stamps)


def test_run_mono_matches_system(tum):
    root = tum["root"]
    argv = ["--dataset", "tum", "--data_path", str(root), "--settings_path",
            str(root / "settings.yaml"), "--out_visualization_path", str(root / "mono"),
            "--device", "cpu"]
    stats = run_mono.main(argv)
    assert stats["frames"] == len(tum["imgs"]) and stats["failures"] == 0
    cfg = run_mono.make_config(run_mono.parse_args(argv))
    s = System(cfg, 240, 320, device="cpu")
    for i, img in enumerate(tum["imgs"]):
        s.track_mono(img, tum["stamps"][i], img_name=f"{i:04d}.png")
    assert s.state.name == "OK"
    s.save_trajectory_kitti(str(root / "mono_mem.txt"))
    assert _read(root / "mono" / "Trajectory_KITTI_000.txt") == _read(root / "mono_mem.txt")
    assert (root / "mono" / "stats.json").exists()


def test_run_rgbd_matches_system(tum):
    root = tum["root"]
    argv = ["--data_path", str(root), "--association_file", str(root / "assoc.txt"),
            "--settings_path", str(root / "settings.yaml"), "--out_visualization_path",
            str(root / "rgbd"), "--device", "cpu"]
    stats = run_rgbd.main(argv)
    assert stats["frames"] == len(tum["imgs"]) and stats["failures"] == 0
    s = System(run_rgbd.make_config(run_rgbd.parse_args(argv)), 240, 320, device="cpu")
    for i, img in enumerate(tum["imgs"]):
        s.track_rgbd(img, tum["depth"][i], tum["stamps"][i], depth_scale=1.0 / 5000.0,
                     img_name=f"{i:04d}.png")
    s.save_trajectory_tum(str(root / "rgbd_mem.txt"))
    assert _read(root / "rgbd" / "CameraTrajectory.txt") == _read(root / "rgbd_mem.txt")
    assert (root / "rgbd" / "failure_log.txt").exists()


def test_run_stream_matches_system(kitti, tmp_path):
    """A watched directory holding 4 pairs, the stream then quiet."""
    watch = tmp_path / "live"
    for d in ("image_0", "image_1"):
        (watch / d).mkdir(parents=True)
        for i in range(4):
            shutil.copy(kitti["seq"] / d / f"{i:06d}.png", watch / d / f"{i:06d}.png")
    stats = run_stream.main(["--watch_dir", str(watch), "--settings_path",
                             str(kitti["root"] / "settings.yaml"), "--out_path",
                             str(tmp_path / "out"), "--idle_timeout", "0.2", "--fps", "10",
                             "--device", "cpu"])
    assert stats == {"frames": 4, "failures": 0}
    s = System(load_reference_yaml(str(kitti["root"] / "settings.yaml")), 240, 320,
               device="cpu")
    for i, (left, right) in enumerate(kitti["frames"][:4]):
        s.track_stereo(left, right, i / 10.0, img_name=f"{i:06d}.png")
    s.save_trajectory_kitti(str(tmp_path / "mem.txt"))
    assert _read(tmp_path / "out" / "Trajectory_KITTI_000.txt") == _read(tmp_path / "mem.txt")


def test_run_batch(kitti, tmp_path):
    """One Jackal-layout session through a run_stereo process (--device
    cpu), and the command lines of both modes."""
    sess = tmp_path / "sessions" / "00019"
    for d in ("image_0", "image_1"):
        (sess / d).mkdir(parents=True)
        for i in range(3):
            shutil.copy(kitti["seq"] / d / f"{i:06d}.png", sess / d / f"{i:06d}.png")
    base = ["--sessions_root", str(tmp_path / "sessions"), "--sessions", "00019",
            "--settings", str(kitti["root"] / "settings.yaml"), "--out", str(tmp_path / "out"),
            "--device", "cpu"]
    assert run_batch.main(["--mode", "inference", *base]) == [0]
    for f in ("Trajectory_KITTI_000.txt", "KeyFrameTrajectory_TUM_000.txt",
              "failure_log.txt", "stats.json"):
        assert (tmp_path / "out" / "00019" / f).exists(), f
    assert json.loads((tmp_path / "out" / "00019" / "stats.json").read_text())["frames"] == 3
    args = run_batch.argparse.Namespace(
        mode="datagen", sessions_root="r", settings="s", out="o", dataset="jackal",
        introspection_model="", gt_root="g", device="cpu")
    cmd = run_batch.session_command(args, "00020")
    assert cmd[1:3] == ["-m", "iv_slam_tpu_torch.examples.run_stereo"]
    assert "--create_ivslam_dataset" in cmd and os.path.join("g", "00020.txt") in cmd
    args.mode, args.introspection_model = "inference", "ckpt"
    cmd = run_batch.session_command(args, "00020")
    assert cmd[cmd.index("--introspection_model_path") + 1] == "ckpt"


def _value(x):
    """A recorded argument in a form that compares exactly across the two
    packages: arrays by dtype, shape and bytes, numbers as floats."""
    if x is None or isinstance(x, (str, bool)):
        return x
    if isinstance(x, (int, float, np.floating, np.integer)):
        return float(x)
    if isinstance(x, dict):
        return {k: _value(v) for k, v in x.items()}
    a = np.asarray(x)
    return (str(a.dtype), a.shape, a.tobytes())


def _recorder(real, log):
    """A stand-in for `real` (a System class) inside a driver: it logs the
    Config it is built with (when built and when the driver ends) and every
    call's arguments, bound to `real`'s own signature, and writes each
    output file empty."""

    class Recorder:
        def __init__(self, cfg, h, w, device=None):
            self.cfg, self.state, self.failure_count, self.poses = cfg, \
                SimpleNamespace(name="OK"), 0, []
            log.append(("System", dataclasses.asdict(cfg), h, w))
            self.tracking = SimpleNamespace(stage_timer=None, datagen=None, current=None,
                                            submit_frontend=self.submit_frontend)

        def _call(self, name, *args, **kw):
            bound = inspect.signature(getattr(real, name)).bind(self, *args, **kw)
            bound.apply_defaults()
            a = dict(bound.arguments)
            del a["self"]
            handle = a.pop("frontend_handle", None)
            if handle is not None:
                a["img_left"], a["img_right"], a["cost_map"] = handle
            self.poses.append(a.get("gt_pose"))
            log.append((name, {k: _value(v) for k, v in a.items()}))

        def submit_frontend(self, img_left, img_right, cost_map=None):
            return img_left, img_right, cost_map

        def track_stereo(self, *args, **kw):
            self._call("track_stereo", *args, **kw)

        def track_mono(self, *args, **kw):
            self._call("track_mono", *args, **kw)

        def track_rgbd(self, *args, **kw):
            self._call("track_rgbd", *args, **kw)

        def enable_datagen(self, out_path=None):
            log.append(("enable_datagen", out_path))
            self.tracking.datagen = SimpleNamespace(
                finalize=lambda: log.append(("finalize",)),
                set_rel_pose_uncertainty=lambda unc, idx: log.append(
                    ("set_rel_pose_uncertainty", _value(unc), idx)))

        def trajectory_twc(self):
            return [np.eye(4) if T is None else np.asarray(T) for T in self.poses]

        def __getattr__(self, name):
            if not name.startswith("save_"):
                raise AttributeError(name)

            def save(path):
                log.append((name, path, dataclasses.asdict(self.cfg)))
                open(path, "w").close()
            return save

    return Recorder


def _drive_both(monkeypatch, name, argv):
    """(JAX log, port log) of driver `name` run with System replaced by a
    recorder in each package."""
    import iv_slam_tpu.slam.system as jsystem
    import iv_slam_tpu_torch.slam.system as psystem
    from iv_slam_tpu_torch import examples

    logs = {}
    for pkg, mod in (("jax", jsystem), ("port", psystem)):
        log = logs[pkg] = []
        with monkeypatch.context() as m:
            m.setattr(mod, "System", _recorder(mod.System, log))
            prev = signal.getsignal(signal.SIGINT)
            try:
                if pkg == "jax":
                    m.setattr(sys, "argv", [f"{name}.py", *argv])
                    m.setattr(sys, "path", list(sys.path))
                    runpy.run_path(os.path.join(REPO, "examples", f"{name}.py"),
                                   run_name="__main__")
                else:
                    getattr(examples, name).main([*argv, "--device", "cpu"])
            finally:
                signal.signal(signal.SIGINT, prev)
    return logs["jax"], logs["port"]


def _stereo_flags(kitti, tmp):
    """Frames 2-9, rectified, decoded in the loop, cost maps for every
    other frame from PNGs, training data with pose uncertainties."""
    qual = tmp / "qual"
    qual.mkdir()
    for i in range(2, 10, 2):
        write_png(str(qual / f"{i:06d}.png"), (np.arange(240 * 320) % 251).astype(
            np.uint8).reshape(240, 320))
    unc = tmp / "unc.txt"
    np.savetxt(unc, np.random.default_rng(3).random((N_FRAMES, 2)), delimiter=",")
    return ["--start_frame", "2", "--end_frame", "10", "--rectify_images", "--sync_loader",
            "--fused_tracking", "--img_qual_path", str(qual), "--create_ivslam_dataset",
            "--load_rel_pose_uncertainty", "--rel_pose_uncertainty_path", str(unc),
            "--ivslam_enabled", "--inference_mode", "--profile_stages"]


@pytest.mark.parametrize("case", ["stereo", "stereo_flags", "stereo_jackal", "mono_tum",
                                  "mono_kitti", "rgbd", "rgbd_scale", "stream"])
def test_drivers_feed_system_as_jax(kitti, tum, tmp_path, monkeypatch, case):
    """Each driver builds System from the same Config (every field) and
    hands it the same arguments, frame by frame, as the JAX package's."""
    root, seq, out = kitti["root"], kitti["seq"], str(tmp_path / "out")
    settings = ["--settings_path", str(root / "settings.yaml")]
    stereo = ["--data_path", str(seq), *settings, "--ground_truth_path", str(root / "00.txt"),
              "--out_visualization_path", out]
    tum_root = tum["root"]
    tum_settings = ["--settings_path", str(tum_root / "settings.yaml")]
    rgbd = ["--data_path", str(tum_root), "--association_file", str(tum_root / "assoc.txt"),
            *tum_settings, "--out_visualization_path", out]
    if case == "stream":
        watch = tmp_path / "live"
        for d in ("image_0", "image_1"):
            (watch / d).mkdir(parents=True)
            for i in range(3):
                shutil.copy(seq / d / f"{i:06d}.png", watch / d / f"{i:06d}.png")
    name, argv = {
        "stereo": ("run_stereo", stereo),
        "stereo_flags": ("run_stereo", stereo + _stereo_flags(kitti, tmp_path)),
        "stereo_jackal": ("run_stereo", ["--dataset", "jackal", "--data_path", str(seq),
                                         *settings, "--out_visualization_path", out]),
        "mono_tum": ("run_mono", ["--dataset", "tum", "--data_path", str(tum_root),
                                  *tum_settings, "--out_visualization_path", out]),
        "mono_kitti": ("run_mono", stereo + ["--start_frame", "3", "--end_frame", "8",
                                             "--create_ivslam_dataset"]),
        "rgbd": ("run_rgbd", rgbd),
        "rgbd_scale": ("run_rgbd", rgbd + ["--depth_scale", "0.001"]),
        "stream": ("run_stream", ["--watch_dir", str(tmp_path / "live"), *settings,
                                  "--out_path", out, "--idle_timeout", "0.2", "--fps", "10",
                                  "--fused_tracking"]),
    }[case]
    want, got = _drive_both(monkeypatch, name, argv)
    assert sum(e[0].startswith("track_") for e in want) > 2
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"entry {i}: {g[0]}"


@pytest.mark.parametrize("mode,extra", [("inference", []),
                                        ("inference", ["--introspection_model", "m"]),
                                        ("datagen", ["--gt_root", "g"])])
def test_run_batch_commands_match_jax(monkeypatch, mode, extra):
    """The run_stereo command line of every session, as the JAX package's
    examples/run_batch.py builds it (less the interpreter's script or module
    name and --device)."""
    argv = ["--mode", mode, "--sessions_root", "r", "--sessions", "00019", "00020",
            "--settings", "s.yaml", "--out", "o", *extra]
    cmds = []

    def record(cmd, **_kw):
        cmds.append(list(cmd))
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(subprocess, "run", record)
    monkeypatch.setattr(sys, "argv", ["run_batch.py", *argv])
    runpy.run_path(os.path.join(REPO, "examples", "run_batch.py"), run_name="__main__")
    want = [c[2:] for c in cmds]
    cmds.clear()
    assert run_batch.main([*argv, "--device", "cpu"]) == [0, 0]
    for c in cmds:
        i = c.index("--device")
        assert c[1:3] == ["-m", "iv_slam_tpu_torch.examples.run_stereo"]
        assert c[i + 1] == "cpu"
        del c[i:i + 2]
    assert [c[3:] for c in cmds] == want


def _trajectories(rng, n):
    out, x = [], np.zeros(3)
    for _ in range(n):
        x = x + rng.normal(0.5, 0.1, 3)
        T = np.eye(4)
        T[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0] * [1, 1, 1]
        T[:3, :3] *= np.sign(np.linalg.det(T[:3, :3]))
        T[:3, 3] = x
        out.append(T)
    return out


@pytest.mark.parametrize("rpe", [[], ["--rpe_delta", "2"], ["--rpe_delta_m", "1.5"]])
def test_evaluate_batch_matches_jax(tmp_path, monkeypatch, rpe):
    rng = np.random.default_rng(11)
    for sess in ("s1", "s2"):
        gt = _trajectories(rng, 12)
        trajectory.save_kitti(str(tmp_path / f"{sess}.txt"), gt)
        for mode, k in (("ORB_SLAM", 2), ("IV_SLAM", 1)):
            d = tmp_path / "res" / mode / sess
            d.mkdir(parents=True)
            est = [T.copy() for T in gt[: 12 - k]]
            for T in est:
                T[:3, 3] += rng.normal(0, 0.05, 3)
            trajectory.save_kitti(str(d / "Trajectory_KITTI_000.txt"), est)
            (d / "failure_log.txt").write_text("1.0\n" * k)
    args = ["--results_root", str(tmp_path / "res"), "--gt_root", str(tmp_path),
            "--sessions", "s1", "s2", "missing", *rpe]
    got = evaluate_batch.main(args + ["--out", str(tmp_path / "port.json")])
    monkeypatch.setattr(sys, "argv", ["evaluate_batch.py", *args, "--out",
                                      str(tmp_path / "jax.json")])
    runpy.run_path(os.path.join(REPO, "examples", "evaluate_batch.py"), run_name="__main__")
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == want
    assert json.loads(json.dumps(got)) == want


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A seeded IntrospectionNet saved as Trainer.save writes it."""
    torch.manual_seed(5)
    net = build_net(TrainConfig())
    path = str(tmp_path_factory.mktemp("ckpt") / "best")
    torch.save({"model": net.state_dict(), "step": 0}, path)
    return path, net.eval()


def test_eval_introspection_inference(checkpoint, dataset, tmp_path):  # noqa: F811
    """Cost maps of session 1's RGB images equal the port's
    inference_cost_map; overlays written."""
    path, net = checkpoint
    img_dir = os.path.join(dataset[1], "00001", "image_0")
    names = eval_introspection.main(["--mode", "inference", "--ckpt", path, "--img_dir",
                                     img_dir, "--out_dir", str(tmp_path), "--save_overlays",
                                     "--device", "cpu"])
    assert names == sorted(os.listdir(img_dir))
    img = read_png(os.path.join(img_dir, names[0]))
    want = inference_cost_map(net, torch.as_tensor(img), img.shape[:2], (512, 512)).numpy()
    np.testing.assert_array_equal(read_png(str(tmp_path / names[0])), want)
    assert (tmp_path / ("overlay_" + names[0])).exists()


def test_eval_introspection_eval_and_retention(checkpoint, dataset):  # noqa: F811
    path, net = checkpoint
    data_root, raw_root, net_root = dataset
    common = ["--ckpt", path, "--data_root", data_root, "--raw_img_root", raw_root,
              "--device", "cpu"]
    report = eval_introspection.main(["--mode", "eval", "--sessions", "0", *common])
    ds = ImageQualityDataset(data_root, raw_root, [0])
    want = [float(eval_loss(net, b)) for b in ds.batches(1, np.random.default_rng(0),
                                                         shuffle=False)]
    assert report == dict(masked_mse=float(np.mean(want)), n=len(want))
    curve = eval_introspection.main(["--mode", "retention", "--sessions", "0", "1",
                                     "--img_dir", net_root, *common])
    jds = jdata.ImageQualityDatasetPP(data_root, raw_root, [0, 1], network_output_root=net_root)
    costs, errs = [], []
    for i in range(len(jds)):
        s = jds[i]
        xi = np.clip(s.keypt_xy[:, 0].astype(int), 0, s.network_output.shape[1] - 1)
        yi = np.clip(s.keypt_xy[:, 1].astype(int), 0, s.network_output.shape[0] - 1)
        costs.append(s.network_output[yi, xi, 0].astype(np.float32))
        errs.append(s.keypt_epipolar_err)
    assert curve == jdata.retention_curve(np.concatenate(costs), np.concatenate(errs))
