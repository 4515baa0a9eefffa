"""Port parity: the ORB extractor (iv_slam_tpu_torch.ops.extractor) vs the
JAX package's, on CPU tensors (plain versions of kernels 1 and 2): the
histogram path, the top-k path, and the introspection-weighted selection
(a uint8 cost map scales responses and sets per-cell budgets).

Keypoint sets, their slot order, responses, angles and descriptors are
integer or exactly reproduced float computations: every field is required
to be exactly equal. The JAX extractor runs jitted on an XLA:CPU target
without FMA contraction (tests/torch_parity.py explains why).
"""

import math

import cv2
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iv_slam_tpu.config import ORBConfig as JORBConfig
from iv_slam_tpu.ops import extractor as jext
from iv_slam_tpu_torch.config import ORBConfig
from iv_slam_tpu_torch.ops import extractor as text
from iv_slam_tpu_torch.ops import fast as tfast
from iv_slam_tpu_torch.ops import pyramid as tpyr
from torch_parity import run_reference

FIELDS = ("xy", "octave", "valid", "response", "yx_level", "angle", "desc")


def _golden_img():
    """tests/test_extractor.py's image."""
    rng = np.random.default_rng(7)
    im = rng.uniform(0, 255, size=(240, 320)).astype(np.float32)
    im = cv2.GaussianBlur(im, (5, 5), 1.2)
    for _ in range(40):
        y, x = rng.integers(20, 220), rng.integers(20, 300)
        im[y:y + 8, x:x + 8] = rng.uniform(0, 255)
    return np.clip(im, 0, 255).astype(np.uint8)


def _texture(seed, h, w):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, (h, w)).astype(np.uint8)


@pytest.mark.parametrize("img_kind,n_levels,ini,min_", [
    ("golden", 8, 12, 7),
    ("texture", 4, 20, 7),
])
def test_extractor_matches_jax(img_kind, n_levels, ini, min_, tmp_path):
    img = _golden_img() if img_kind == "golden" else _texture(5, 240, 320)
    kw = dict(n_features=500, n_levels=n_levels, ini_th_fast=ini, min_th_fast=min_)
    ref = run_reference("extract", tmp_path, img=img, n_features=500,
                        n_levels=n_levels, ini=ini, min_=min_)
    tx = text.OrbExtractor(ORBConfig(**kw), *img.shape)
    got = tx(torch.from_numpy(img))
    assert int(got.valid.sum()) > 300
    for f in FIELDS:
        a = getattr(got, f).numpy()
        assert a.dtype == ref[f].dtype, (f, a.dtype, ref[f].dtype)
        np.testing.assert_array_equal(a, ref[f], err_msg=f)


def test_batched_pair_equals_single_images(tmp_path):
    """The explicit batch dimension (left/right) gives per-image results
    identical to single-image extraction, and to the JAX batched path."""
    imgs = np.stack([_golden_img(), _texture(6, 240, 320)])
    kw = dict(n_features=400, n_levels=4, ini_th_fast=20, min_th_fast=7)
    tx = text.OrbExtractor(ORBConfig(**kw), 240, 320)
    levels = tpyr.build_pyramid(torch.from_numpy(imgs), tx.shapes)
    kb, canvas = tx.extract_from_pyramid_batched(levels, return_canvas=True)
    ref = run_reference("extract_pair", tmp_path, imgs=imgs, n_features=400,
                        n_levels=4, ini=20, min_=7)
    np.testing.assert_array_equal(canvas.numpy(), ref["canvas"])
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(kb, f).numpy(), ref[f], err_msg=f)
    for b in range(2):
        single = tx(torch.from_numpy(imgs[b]))
        for f in FIELDS:
            assert torch.equal(getattr(single, f), getattr(kb, f)[b]), f


def test_redistribute_matches_jax():
    rng = np.random.default_rng(3)
    n_cells = 37
    tot = rng.integers(0, 30, (6, n_cells)).astype(np.int32)
    bud = rng.integers(0, 20, (6, n_cells)).astype(np.int32)
    tot[0] = 0                      # nothing detected
    bud[1] = 0                      # padded row
    ref = np.stack([np.asarray(jext._redistribute(jnp.asarray(t), jnp.asarray(b),
                                                  n_cells)) for t, b in zip(tot, bud)])
    got = text._redistribute(torch.from_numpy(tot), torch.from_numpy(bud), n_cells)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_layouts_match_jax():
    for hw in ((240, 320), (376, 1241)):
        a = text.make_layouts(ORBConfig(n_features=2000, n_levels=8), *hw)
        b = jext.make_layouts(JORBConfig(n_features=2000, n_levels=8), *hw)
        assert [tuple(vars(x).values()) for x in a] == [tuple(vars(y).values()) for y in b]
        assert [x.active for x in a] == [y.active for y in b]


def test_unported_paths_raise():
    """The quadtree path, once refused (A14), is ported: it gives a full
    keypoint bundle (its parity with JAX is tests/test_torch_octtree.py).
    An unknown selection path still raises."""
    tx = text.OrbExtractor(ORBConfig(n_features=300, n_levels=4), 120, 160)
    img = torch.from_numpy(_texture(1, 120, 160))
    kp = tx.extract_octtree(img)
    assert tuple(kp.desc.shape) == (tx.capacity, 32) and int(kp.valid.sum()) > 0
    bad = text.OrbExtractor(ORBConfig(n_features=300, n_levels=4, select_path="grid"),
                            120, 160)
    with pytest.raises(ValueError, match="select_path"):
        bad(img)


# ---- top-k and introspection-weighted selection ----------------------------

def _cost_map(kind, seed, h, w):
    """uint8 cost maps: smooth waves with noise, a bad right half, blocks."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    if kind == "waves":
        m = 128 + 127 * np.sin(xx / 23.0) * np.cos(yy / 17.0) + rng.normal(0, 20, (h, w))
    elif kind == "half":
        m = np.where(xx >= w // 2, 255.0, 0.0)
    else:
        m = np.kron(rng.integers(0, 256, (h // 16 + 1, w // 16 + 1)), np.ones((16, 16)))[:h, :w]
    return np.clip(m, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def kitti_budgets(tmp_path_factory):
    quals = np.stack([_cost_map(k, s, 376, 1241) for k, s in
                      (("waves", 0), ("waves", 1), ("half", 0), ("blocks", 2), ("blocks", 3))])
    ref = run_reference("cell_budgets", tmp_path_factory.mktemp("budgets"), quals=quals,
                        n_features=2000, n_levels=8)
    return quals, ref


def test_cell_quality_weights_and_budgets_match_jax(kitti_budgets):
    """At KITTI-00 geometry (80, 52, 52, 27, 27, 27, 12 and 12 cells): the
    cost map's pyramid, each cell's weight and each cell's budget exact."""
    quals, ref = kitti_budgets
    lays = text.make_layouts(ORBConfig(n_features=2000, n_levels=8), 376, 1241)
    levels = tpyr.build_pyramid(torch.from_numpy(quals), [(l.h, l.w) for l in lays])
    assert [l.n_cells for l in lays] == [80, 52, 52, 27, 27, 27, 12, 12]
    for i, (lay, q) in enumerate(zip(lays, levels)):
        np.testing.assert_array_equal(q.numpy(), ref[f"q{i}"], err_msg=f"level {i}")
        win = torch.from_numpy(text._cell_window_table(lay))
        w = text._cell_quality_weights(q, win)
        np.testing.assert_array_equal(w.numpy(), ref[f"w{i}"], err_msg=f"weights {i}")
        b = text._cell_quality_budgets(q, win, lay.n_desired)
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(b.numpy(), ref[f"b{i}"], err_msg=f"budgets {i}")


@pytest.fixture(scope="module")
def selection(tmp_path_factory):
    imgs = np.stack([_golden_img(), _texture(8, 240, 320)])
    quals = np.stack([_cost_map("waves", 4, 240, 320), _cost_map("blocks", 5, 240, 320)])
    ref = run_reference("select", tmp_path_factory.mktemp("select"), imgs=imgs, quals=quals,
                        n_features=500, n_levels=8, ini=12, min_=7)
    return imgs, quals, ref


@pytest.mark.parametrize("weighted", [True, False], ids=["cost map", "no cost map"])
def test_select_level_keypoints_matches_jax(selection, weighted):
    """OrbExtractor.select's top-k path against the reference's
    _select_level_keypoints on the FAST map of every level: each slot's
    position, response (float products with the pixel's quality) and
    validity exact, in order."""
    imgs, quals, ref = selection
    tx = text.OrbExtractor(ORBConfig(n_features=500, n_levels=8, ini_th_fast=12,
                                     min_th_fast=7, select_path="topk"), 240, 320)
    levels = tpyr.build_pyramid(torch.from_numpy(imgs), tx.shapes)
    qlevels = tpyr.build_pyramid(torch.from_numpy(quals), tx.shapes) if weighted else None
    pre = "q_" if weighted else "n_"
    outs = tx.select(levels, qlevels)
    assert len(outs) == 8
    for lvl, yx, resp, valid, _ in outs:
        for name, got in (("y", yx[..., 0]), ("x", yx[..., 1]), ("resp", resp),
                          ("valid", valid)):
            want = ref[f"{pre}{name}{lvl}"]
            assert got.numpy().dtype == want.dtype, (name, lvl)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{name} level {lvl}")
    if weighted:   # the quality makes responses non-integer
        r = outs[0][2][outs[0][3]]
        assert (r != torch.round(r)).any()


@pytest.mark.parametrize("img_kind,n_levels,cost,select_path", [
    ("golden", 8, "waves", "hist"),
    ("texture", 4, "half", "hist"),
    ("golden", 8, None, "topk"),
])
def test_weighted_extractor_matches_jax(img_kind, n_levels, cost, select_path, tmp_path):
    """OrbExtractor(img, quality) end to end: every Keypoints field exact."""
    img = _golden_img() if img_kind == "golden" else _texture(5, 240, 320)
    q = None if cost is None else _cost_map(cost, 6, 240, 320)
    kw = dict(n_features=500, n_levels=n_levels, ini_th_fast=12, min_th_fast=7)
    ref = run_reference("extract", tmp_path, img=img, **{"n_features": 500, "n_levels": n_levels,
                                                        "ini": 12, "min_": 7},
                        select_path=select_path, **({} if q is None else {"quality": q}))
    tx = text.OrbExtractor(ORBConfig(select_path=select_path, **kw), *img.shape)
    got = tx(torch.from_numpy(img), None if q is None else torch.from_numpy(q))
    assert int(got.valid.sum()) > 300
    for f in FIELDS:
        a = getattr(got, f).numpy()
        assert a.dtype == ref[f].dtype, (f, a.dtype, ref[f].dtype)
        np.testing.assert_array_equal(a, ref[f], err_msg=f)


def test_hist_selection_matches_topk():
    """tests/test_extractor.py's check on the port: the histogram path
    reproduces the top-k path (keypoints, slot order, tie-breaking) on
    sparse score maps with many equal scores and on dense FAST maps."""
    lays = text.make_layouts(ORBConfig(n_features=800, n_levels=4), 240, 320)

    def both(smap, lay):
        t, n_tot = text._level_score_tiles(torch.from_numpy(smap)[None], lay, 20)
        bud = torch.full((1, lay.n_cells), math.ceil(lay.n_desired / lay.n_cells),
                         dtype=torch.int32)
        n_ret = text._redistribute(n_tot, bud, lay.n_cells)
        return (text._select_from_tiles_hist(t, n_ret, lay),
                text._select_from_tiles_topk(t, n_ret, None, lay))

    maps = []
    for seed in range(3):
        r = np.random.default_rng(seed)
        for lay in lays:
            smap = np.zeros((lay.h, lay.w), np.int16)
            n_pts = int(r.integers(30, 1500))
            smap[r.integers(0, lay.h, n_pts), r.integers(0, lay.w, n_pts)] = \
                r.integers(7, 255, n_pts)
            maps.append((smap, lay))
    img = torch.from_numpy(_texture(0, 240, 320))
    for lay, lv in zip(lays, tpyr.build_pyramid(img, [(l.h, l.w) for l in lays])):
        maps.append((tfast.fast_score(lv, 7).numpy(), lay))
    for smap, lay in maps:
        h, k = both(smap, lay)
        assert torch.equal(h[3], k[3])
        m = h[3]
        for a, b in zip(h[:3], k[:3]):
            assert torch.equal(a[m], b[m])


def test_extractor_quality_weighting_shifts_budget():
    """tests/test_extractor.py's check on the port: with the right half of
    the cost map at 255, the right half keeps far fewer keypoints."""
    img = _golden_img()
    ext = text.OrbExtractor(ORBConfig(n_features=400, enable_introspection=True), *img.shape)
    qual = np.zeros(img.shape, np.uint8)
    qual[:, img.shape[1] // 2:] = 255
    kp_w = ext(torch.from_numpy(img), torch.from_numpy(qual))
    kp_p = ext(torch.from_numpy(img))
    frac_w = (kp_w.xy[kp_w.valid, 0] > img.shape[1] / 2).float().mean()
    frac_p = (kp_p.xy[kp_p.valid, 0] > img.shape[1] / 2).float().mean()
    assert frac_w < frac_p * 0.6
