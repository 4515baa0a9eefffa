"""Port parity: ShardedDatagen (iv_slam_tpu_torch.parallel.datagen) on the
CPU against the JAX package's on its virtual 8-device CPU mesh, at the
size of tests/test_sharded_datagen.py (320x240, 300 features, 3 levels,
9 frames, score cap 128, batches of 5 overlapping by one frame).

Both write the reference's dataset schema; the test holds the written
files against each other: the same image names, heatmaps within one grey
level (the GP's float32 Cholesky solves order their sums differently),
masks alike but where the GP variance sits on the threshold (measured: 1
or 2 pixels of 614,400 flipped from run to run; held to 0.1%), keypoint
coordinates exact, epipolar errors within 1e-4 relative to their largest.
As in the JAX test, the clean world's lower bad-share gate is lifted
(MIN_BAD_PERCENT -1), so that frames are written.
"""

import json
import os

import numpy as np
import pytest

import synth_world
from iv_slam_tpu.config import CameraConfig, Config, ORBConfig
from iv_slam_tpu.introspection import feature_evaluator as jfe
from iv_slam_tpu.parallel.datagen import ShardedDatagen as JShardedDatagen
from iv_slam_tpu.parallel.replay import make_replay_mesh
from iv_slam_tpu_torch import config as tconfig
from iv_slam_tpu_torch.introspection import feature_evaluator as tfe
from iv_slam_tpu_torch.parallel.datagen import ShardedDatagen
from iv_slam_tpu_torch.io.png import read_png
from torch_parity import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

H, W = 240, 320


def configs():
    j = Config()
    j.camera = CameraConfig(fx=400.0, fy=400.0, cx=160.0, cy=120.0, bf=200.0, width=W,
                            height=H, th_depth=35.0)
    j.orb = ORBConfig(n_features=300, n_levels=3)
    t = tconfig.Config()
    t.camera = tconfig.CameraConfig(fx=400.0, fy=400.0, cx=160.0, cy=120.0, bf=200.0, width=W,
                                    height=H, th_depth=35.0)
    t.orb = tconfig.ORBConfig(n_features=300, n_levels=3)
    return j, t


def written(out):
    names = sorted(os.listdir(os.path.join(out, "bad_region_heatmap")))
    heat = [read_png(os.path.join(out, "bad_region_heatmap", n)) for n in names]
    mask = [read_png(os.path.join(out, "bad_region_heatmap_mask", n)) for n in names]
    with open(os.path.join(out, "keypoints.json")) as f:
        kp = json.load(f)
    return names, heat, mask, kp


def test_sharded_datagen_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jfe, "MIN_BAD_PERCENT", -1.0)
    monkeypatch.setattr(tfe, "MIN_BAD_PERCENT", -1.0)
    _world, frames, gt = synth_world.make_sequence(np.random.default_rng(0), n_frames=9,
                                                   step=0.12)
    jcfg, tcfg = configs()
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    jstats = JShardedDatagen(jcfg, H, W, make_replay_mesh(8), out_path=jout,
                             score_cap=128).process_session(frames, gt, batch=5)
    dg = ShardedDatagen(tcfg, H, W, out_path=tout, score_cap=128, device="cpu")
    tstats = dg.process_session(frames, gt, batch=5)
    print(f"JAX {jstats}\nport {tstats}")
    assert tstats["n_pairs"] == jstats["n_pairs"] == len(frames) - 1
    assert tstats["n_good"] == jstats["n_good"] > 0 and dg.n_saved == tstats["n_good"]
    np.testing.assert_allclose(tstats["mean_bad_pct"], jstats["mean_bad_pct"], atol=1e-3)
    jn, jh, jm, jk = written(jout)
    tn, th, tm, tk = written(tout)
    assert tn == jn
    for a, b in zip(th, jh):
        assert a.shape == b.shape and np.abs(a.astype(int) - b.astype(int)).max() <= 1
    flips = sum(int((a != b).sum()) for a, b in zip(tm, jm))
    print(f"mask pixels flipped: {flips} of {sum(m.size for m in jm)}")
    assert flips <= 1e-3 * sum(m.size for m in jm)
    for key in ("x_coord", "y_coord", "response", "size"):
        np.testing.assert_array_equal(tk[key], jk[key], err_msg=key)
    err_j, err_t = np.asarray(jk["epipolar_err"]), np.asarray(tk["epipolar_err"])
    np.testing.assert_allclose(err_t, err_j, atol=1e-4 * max(float(err_j.max()), 1.0))
