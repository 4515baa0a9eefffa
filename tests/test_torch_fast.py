"""Port parity: the plain FAST score (iv_slam_tpu_torch.ops.fast) and the
kernel-1 wrapper's CPU dispatch vs the JAX package's XLA version and its
Pallas kernel in interpret mode. Integer arithmetic: exactly equal.
"""

import importlib.util
import os

import cv2
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iv_slam_tpu.ops import fast as jfast
from iv_slam_tpu.ops import fast_pallas
from iv_slam_tpu_torch.ops import fast as tfast
from iv_slam_tpu_torch.ops import fast_cuda


def _textured(rng, h, w):
    img = rng.uniform(0, 255, size=(h, w)).astype(np.float32)
    img = cv2.GaussianBlur(img, (5, 5), 1.2)
    for _ in range(60):
        y, x = rng.integers(10, h - 20), rng.integers(10, w - 20)
        img[y:y + 6, x:x + 6] = rng.uniform(0, 255)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("hw,th,kind", [
    ((240, 320), 12, "textured"),   # tests/test_fast_pallas.py's input
    ((100, 150), 7, "noise"),       # its non-aligned size
    ((87, 203), 20, "textured"),    # non-aligned, KITTI iniTh
])
def test_fast_score_matches_jax_and_pallas(hw, th, kind):
    rng = np.random.default_rng(42)
    img = (_textured(rng, *hw) if kind == "textured"
           else rng.uniform(0, 255, size=hw).astype(np.uint8))
    ref = np.asarray(jfast.fast_score(jnp.asarray(img), th))
    pal = np.asarray(fast_pallas.fast_score_pallas(jnp.asarray(img), th,
                                                   interpret=True))
    got = tfast.fast_score(torch.from_numpy(img), th).numpy()
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pal)
    assert (got > 0).sum() > 0


def test_wrapper_cpu_dispatch_batched():
    """The kernel-1 wrapper on CPU tensors takes the plain version; a batch
    equals the per-image results."""
    rng = np.random.default_rng(5)
    imgs = np.stack([_textured(rng, 96, 130) for _ in range(2)])
    before = fast_cuda.launches
    got = fast_cuda.fast_score(torch.from_numpy(imgs), 7).numpy()
    assert fast_cuda.launches == before  # no kernel on the CPU
    for b in range(2):
        ref = np.asarray(jfast.fast_score(jnp.asarray(imgs[b]), 7))
        np.testing.assert_array_equal(got[b], ref)


def test_levels_wrapper_cpu_dispatch_matches_jax():
    """fast_score_levels on CPU tensors: 5 levels of different odd sizes,
    B=2, each level and image equal to the JAX package's fast_score; no
    kernel launch on the CPU."""
    rng = np.random.default_rng(11)
    shapes = [(97, 131), (81, 109), (67, 91), (55, 75), (45, 63)]
    levels = [np.stack([_textured(rng, h, w) for _ in range(2)]) for h, w in shapes]
    before = fast_cuda.launches
    got = fast_cuda.fast_score_levels([torch.from_numpy(lv) for lv in levels], 7)
    assert fast_cuda.launches == before
    assert len(got) == len(levels)
    for lv, g in zip(levels, got):
        assert g.dtype == torch.int16 and tuple(g.shape) == lv.shape
        for b in range(2):
            ref = np.asarray(jfast.fast_score(jnp.asarray(lv[b]), 7))
            np.testing.assert_array_equal(g[b].numpy(), ref)
    assert fast_cuda.fast_score_levels([], 7) == []


def _fast_counted(img, th):
    """FAST scores from the ring bytes in two-input operations, counting
    each: the least work chip_smoke.py charges K1's bound. The 16 circular
    9-window minima (and maxima) come from suffix and prefix runs inside
    ring halves 0-7 and 8-15 and one operation a window; the bright score is
    their best minimum less the center, the dark one the center less their
    least maximum. Returns (scores, operations a pixel)."""
    count = [0]

    def op(f, *args):
        count[0] += 1
        return f(*args)

    h, w = img.shape
    im = img.astype(np.int32)
    c = im[3:h - 3, 3:w - 3]
    r = [im[3 + dy:h - 3 + dy, 3 + dx:w - 3 + dx] for dy, dx in tfast.CIRCLE]

    def windows(f):
        suf, pre = {}, {}
        for b in (0, 8):
            suf[b + 7], pre[b] = r[b + 7], r[b]
            for i in range(b + 6, b - 1, -1):
                suf[i] = op(f, r[i], suf[i + 1])
            for i in range(b + 1, b + 7):
                pre[i] = op(f, pre[i - 1], r[i])
            pre[b + 7] = suf[b]  # the whole half, formed once
        return [op(f, suf[k], pre[(k + 8) % 16]) for k in range(16)]

    def reduce(f, xs):
        acc = xs[0]
        for x in xs[1:]:
            acc = op(f, acc, x)
        return acc

    bright = op(np.subtract, reduce(np.maximum, windows(np.minimum)), c)
    dark = op(np.subtract, c, reduce(np.minimum, windows(np.maximum)))
    score = op(np.subtract, op(np.maximum, bright, dark), 1)
    kept = op(np.where, op(np.greater_equal, score, th), score, 0)
    out = np.zeros((h, w), np.int16)
    out[3:h - 3, 3:w - 3] = kept
    return out, count[0]


@pytest.mark.parametrize("th", [0, 7, 20])
def test_k1_bound_counts_the_least_work(th):
    """The operation count of K1's bound in chip_smoke.py is that of a
    formulation which computes FAST exactly: equal to the JAX package's
    fast_score on textured and noise images."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rng = np.random.default_rng(th)
    for img in (_textured(rng, 67, 91), rng.integers(0, 256, (40, 57), dtype=np.uint8)):
        got, n_ops = _fast_counted(img, th)
        assert n_ops == smoke.FAST_OPS_PER_PX == 120
        np.testing.assert_array_equal(got, np.asarray(jfast.fast_score(jnp.asarray(img), th)))


def test_nonmax_suppress_matches_jax():
    rng = np.random.default_rng(9)
    img = _textured(rng, 120, 160)
    s = jfast.fast_score(jnp.asarray(img), 7)
    ref = np.asarray(jfast.nonmax_suppress(s))
    got = tfast.nonmax_suppress(torch.from_numpy(np.array(s))).numpy()
    np.testing.assert_array_equal(got, ref)
