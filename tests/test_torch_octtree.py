"""Port parity: the quadtree keypoint distribution (iv_slam_tpu_torch
ops/octtree.py) and OrbExtractor.extract_octtree against the JAX
package's.

The cases of tests/test_octtree.py run on the port's functions; the host
quadtree is also held equal to the JAX package's on random candidates, and
extract_octtree on two images (every field exact: the same keypoints in
the same order, responses, angles and descriptors). The JAX reference runs
in a subprocess on an XLA:CPU target without FMA (tests/torch_parity.py
says why); jitted with FMA, its angles move by up to ~0.03 degrees.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import synth_world
from iv_slam_tpu.ops import octtree as joct
from iv_slam_tpu_torch.config import ORBConfig
from iv_slam_tpu_torch.ops import fast, octtree
from iv_slam_tpu_torch.ops.extractor import OrbExtractor
from torch_parity import NO_FMA_FLAG, one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.usefixtures("one_thread")


# ---- tests/test_octtree.py's cases on the port --------------------------------

def test_distribute_retains_all_when_budget_large():
    rng = np.random.default_rng(0)
    xs = rng.integers(0, 300, 12).astype(np.int32)
    ys = rng.integers(0, 100, 12).astype(np.int32)
    xs = np.unique(xs)[:8]
    ys = ys[: xs.size]
    rs = rng.uniform(1, 50, xs.size).astype(np.float32)
    keep = octtree.distribute_octtree(xs, ys, rs, 0, 300, 0, 100, 50)
    assert sorted(keep.tolist()) == list(range(xs.size))


def test_distribute_budget_one_divides_once_then_stops():
    xs = np.array([10, 50, 90, 30], dtype=np.int32)
    ys = np.array([20, 60, 80, 40], dtype=np.int32)
    rs = np.array([5.0, 9.0, 3.0, 7.0], dtype=np.float32)
    keep = octtree.distribute_octtree(xs, ys, rs, 0, 100, 0, 100, 1)
    assert sorted(keep.tolist()) == [1, 3]


def test_distribute_spatial_coverage():
    rng = np.random.default_rng(1)
    centers = [(25, 25), (75, 25), (25, 75), (75, 75)]
    xs, ys, rs = [], [], []
    for k, (cx, cy) in enumerate(centers):
        px = cx + rng.integers(-5, 6, 10)
        py = cy + rng.integers(-5, 6, 10)
        pr = rng.uniform(1, 10, 10).astype(np.float32)
        pr[3] = 100.0 + k
        xs.extend(px), ys.extend(py), rs.extend(pr)
    xs = np.asarray(xs, np.int32)
    ys = np.asarray(ys, np.int32)
    rs = np.asarray(rs, np.float32)
    keep = octtree.distribute_octtree(xs, ys, rs, 0, 100, 0, 100, 4)
    assert sorted(rs[keep].tolist()) == [100.0, 101.0, 102.0, 103.0]


def test_distribute_overshoot_bounded():
    g = np.arange(0, 200, 5)
    xs, ys = np.meshgrid(g, g)
    xs, ys = xs.ravel().astype(np.int32), ys.ravel().astype(np.int32)
    rs = np.arange(xs.size, dtype=np.float32)
    for n in (10, 37, 100):
        keep = octtree.distribute_octtree(xs, ys, rs, 0, 200, 0, 200, n)
        assert n <= keep.size <= n + 2
        assert np.unique(keep).size == keep.size


def _peak_score_map(h, w, peaks):
    s = np.zeros((h, w), dtype=np.int16)
    for (y, x, v) in peaks:
        s[y, x] = v
    return s


def test_compute_keypoints_octtree_finds_isolated_peaks():
    peaks = [(30, 40, 25), (30, 120, 30), (80, 40, 9), (80, 120, 40)]
    s = _peak_score_map(120, 160, peaks)
    y, x, r = octtree.compute_keypoints_octtree(s, ini_th=12, n_desired=50)
    got = {(yy, xx, rr) for yy, xx, rr in zip(y.tolist(), x.tolist(), r.tolist())}
    assert got == {(30, 40, 25.0), (30, 120, 30.0), (80, 40, 9.0), (80, 120, 40.0)}


def test_compute_keypoints_octtree_nms_within_cell():
    s = _peak_score_map(100, 100, [(50, 50, 20), (50, 51, 30)])
    y, x, r = octtree.compute_keypoints_octtree(s, ini_th=12, n_desired=10)
    assert list(zip(y.tolist(), x.tolist())) == [(50, 51)]


def _corner_image(seed=3):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 60, (240, 320)).astype(np.uint8)
    for _ in range(120):
        yy, xx = rng.integers(25, 210), rng.integers(25, 290)
        img[yy:yy + 4, xx:xx + 4] = 255
    return img


def test_extract_octtree_end_to_end():
    img = _corner_image()
    cfg = ORBConfig(n_features=300, n_levels=4, ini_th_fast=20, min_th_fast=7)
    ex = OrbExtractor(cfg, 240, 320)
    kps = ex.extract_octtree(torch.as_tensor(img))
    valid = kps.valid.numpy()
    assert valid.sum() > 30
    assert tuple(kps.desc.shape) == (ex.capacity, 32)
    ang = kps.angle.numpy()[valid]
    assert np.isfinite(ang).all() and (ang >= 0).all() and (ang < 360).all()
    s0 = fast.fast_score(torch.as_tensor(img), cfg.min_th_fast).numpy()
    lvl0 = valid & (kps.octave.numpy() == 0)
    yx = kps.yx_level.numpy()[lvl0]
    assert (s0[yx[:, 0], yx[:, 1]] > 0).all()
    assert np.allclose(kps.response.numpy()[lvl0], s0[yx[:, 0], yx[:, 1]])


# ---- parity with the JAX package ------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_quadtree_matches_jax(seed):
    """distribute_octtree on random candidates and compute_keypoints_octtree
    on a random sparse score map: the same indices / keypoints."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 400))
    xs = rng.integers(0, 600, n).astype(np.int32)
    ys = rng.integers(0, 180, n).astype(np.int32)
    rs = rng.integers(1, 60, n).astype(np.float32)
    for budget in (1, 17, 80, 500):
        np.testing.assert_array_equal(
            octtree.distribute_octtree(xs, ys, rs, 0, 600, 0, 180, budget),
            joct.distribute_octtree(xs, ys, rs, 0, 600, 0, 180, budget))
    s = np.where(rng.random((190, 630)) < 0.02, rng.integers(1, 80, (190, 630)), 0)
    s = s.astype(np.int16)
    for got, want in zip(octtree.compute_keypoints_octtree(s, 20, 150),
                         joct.compute_keypoints_octtree(s, 20, 150)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


_JAX_EXTRACT = """
import sys
import numpy as np
import jax.numpy as jnp
from iv_slam_tpu.config import ORBConfig
from iv_slam_tpu.ops.extractor import OrbExtractor
z = np.load(sys.argv[1])
out = {}
for k in range(int(z["n"])):
    img, kw = z[f"img{k}"], z[f"cfg{k}"]
    cfg = ORBConfig(n_features=int(kw[0]), n_levels=int(kw[1]), ini_th_fast=int(kw[2]),
                    min_th_fast=int(kw[3]))
    kp = OrbExtractor(cfg, *img.shape).extract_octtree(jnp.asarray(img))
    out.update({f"{f}{k}": np.asarray(getattr(kp, f)) for f in kp._fields})
np.savez(sys.argv[2], **out)
"""


def test_extract_octtree_matches_jax(tmp_path):
    """The random-corner image of test_octtree.py (4 levels, 300 features)
    and a 320x240 frame of tests/synth_world.py (8 levels, 800 features)."""
    world = synth_world.PlaneWorld(np.random.default_rng(7))
    frame = world.render_stereo(synth_world.camera_pose(np.zeros(3, np.float32)))[0]
    cases = [(_corner_image(), (300, 4, 20, 7)), (frame, (800, 8, 20, 7))]
    src, dst = str(tmp_path / "in.npz"), str(tmp_path / "out.npz")
    np.savez(src, n=len(cases), **{f"img{k}": c[0] for k, c in enumerate(cases)},
             **{f"cfg{k}": np.asarray(c[1]) for k, c in enumerate(cases)})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " " + NO_FMA_FLAG).strip())
    proc = subprocess.run([sys.executable, "-c", _JAX_EXTRACT, src, dst], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = np.load(dst)
    for k, (img, kw) in enumerate(cases):
        cfg = ORBConfig(n_features=kw[0], n_levels=kw[1], ini_th_fast=kw[2], min_th_fast=kw[3])
        kp = OrbExtractor(cfg, *img.shape).extract_octtree(torch.as_tensor(img))
        assert int(kp.valid.sum()) > 100
        for f in kp._fields:
            got = getattr(kp, f).numpy()
            assert got.dtype == want[f"{f}{k}"].dtype, f
            np.testing.assert_array_equal(got, want[f"{f}{k}"], err_msg=f"case {k}: {f}")
