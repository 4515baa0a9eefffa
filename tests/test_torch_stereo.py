"""Port parity: stereo matching (iv_slam_tpu_torch.ops.stereo) and the
plain version of kernel 3 vs the JAX package.

SAD values are integers (exact in float32): the plain SAD equals the
Pallas SAD kernel in interpret mode exactly, at random and at clip-limit
window centers. ``match_stereo`` runs on keypoints from the JAX extractor
of a stereo pair and must give exactly the same u_right and depth as the
JAX function compiled without FMA contraction (tests/torch_parity.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from iv_slam_tpu.config import ORBConfig
from iv_slam_tpu.ops import extractor as jext
from iv_slam_tpu.ops import pyramid as jpyr
from iv_slam_tpu.ops import stereo as jstereo
from iv_slam_tpu.ops.stereo_pallas import sad_windows_pallas, _W, _L
from iv_slam_tpu_torch.ops import stereo as tstereo
from iv_slam_tpu_torch.ops import stereo_cuda
from torch_parity import run_reference


def _sad_pair(seed, H, W, yc, xl, xr):
    rng = np.random.default_rng(seed)
    cl = rng.integers(0, 255, (H, W)).astype(np.uint8)
    cr = rng.integers(0, 255, (H, W)).astype(np.uint8)
    ref = np.asarray(sad_windows_pallas(
        jnp.asarray(cl), jnp.asarray(cr), jnp.asarray(yc), jnp.asarray(xl),
        jnp.asarray(xr), interpret=True))
    got = stereo_cuda.sad_windows(
        torch.from_numpy(cl), torch.from_numpy(cr), torch.from_numpy(yc),
        torch.from_numpy(xl), torch.from_numpy(xr)).numpy()
    assert got.shape == (len(yc), 2 * _L + 1) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_sad_plain_matches_pallas_random():
    rng = np.random.default_rng(0)
    H, W, n = 96, 200, 70
    yc = rng.integers(_W, H - _W - 1, n).astype(np.int32)
    xl = rng.integers(_W, W - _W - 1, n).astype(np.int32)
    xr = rng.integers(_W + _L, W - _W - _L - 1, n).astype(np.int32)
    _sad_pair(0, H, W, yc, xl, xr)


def test_sad_plain_matches_pallas_edge_positions():
    H, W = 64, 160
    yc = np.array([_W, H - _W - 1, _W, H - _W - 1], np.int32)
    xl = np.array([_W, W - _W - 1, W - _W - 1, _W], np.int32)
    xr = np.array([_W + _L, W - _W - _L - 1, _W + _L, W - _W - _L - 1], np.int32)
    _sad_pair(1, H, W, yc, xl, xr)


# csrc/sad_windows.cu's range argument: an operand a + cR or b + cL is at
# most 510; a slide's packed sum adds per 16-bit half at most 6 columns x
# 11 rows of |.| (low half: columns 0,2,..,10), and its two halves together
# 121 terms
_OPERAND_MAX = 2 * 255
_HALF_MAX = 6 * (2 * _W + 1) * _OPERAND_MAX   # 33,660
_SAD_MAX = (2 * _W + 1) ** 2 * _OPERAND_MAX   # 61,710


def _sad_packed(cl, cr, yc, xl, xr):
    """numpy emulation of the kernel's arithmetic: operands a + cR and
    b + cL held as uint16, absolute differences as max - min of the halves,
    row sums, then the slide sums accumulated per half in uint16 (each half
    checked against the same sum in int64: no wrap), and the halves added."""
    r = np.arange(-_W, _W + 1)
    s = np.arange(-_W - _L, _W + _L + 1)
    rows = yc[:, None, None] + r[None, :, None]
    IL = cl[rows, xl[:, None, None] + r[None, None, :]].astype(np.uint16)
    IR = cr[rows, xr[:, None, None] + s[None, None, :]].astype(np.uint16)
    cL = IL[:, _W, _W]
    out = np.zeros((len(yc), 2 * _L + 1), np.float32)
    for inc in range(2 * _L + 1):
        cR = IR[:, _W, _W + inc]
        x = IL + cR[:, None, None]                      # a + cR
        y = IR[:, :, inc:inc + 2 * _W + 1] + cL[:, None, None]  # b + cL
        assert x.dtype == y.dtype == np.uint16
        assert x.max(initial=0) <= _OPERAND_MAX and y.max(initial=0) <= _OPERAND_MAX
        d = np.maximum(x, y) - np.minimum(x, y)         # |.|, no borrow
        halves = []
        for cols in (slice(0, None, 2), slice(1, None, 2)):
            rowsum = d[:, :, cols].sum(axis=2, dtype=np.uint16)
            half = rowsum.sum(axis=1, dtype=np.uint16)
            wide = d[:, :, cols].sum(axis=(1, 2), dtype=np.int64)
            assert wide.max(initial=0) <= _HALF_MAX and np.array_equal(half, wide)
            halves.append(half)
        total = halves[0].astype(np.uint32) + halves[1]
        assert total.max(initial=0) <= _SAD_MAX < 1 << 16
        out[:, inc] = total
    return out


def _extreme_pair(H, W, yc, xl, xr):
    """The top of the range: left patches 255 around a center of 0, right
    windows 0 around a center of 255 (every slide's center)."""
    cl = np.full((H, W), 255, np.uint8)
    cr = np.zeros((H, W), np.uint8)
    cl[yc, xl] = 0
    for d in range(-_L, _L + 1):
        cr[yc, xr + d] = 255
    return cl, cr


@pytest.mark.parametrize("fill", ["random", "extreme"])
def test_sad_packed_formulation_matches_plain_and_pallas(fill):
    rng = np.random.default_rng(5)
    H, W, n = 64, 203, 40
    yc = rng.integers(_W, H - _W, n).astype(np.int32)
    xl = rng.integers(_W, W - _W, n).astype(np.int32)
    xr = rng.integers(_W + _L, W - _W - _L, n).astype(np.int32)
    yc[:4] = [_W, H - _W - 1, _W, H - _W - 1]
    xl[:4] = [_W, W - _W - 1, W - _W - 1, _W]
    xr[:4] = [_W + _L, W - _W - _L - 1, _W + _L, W - _W - _L - 1]
    if fill == "random":
        cl = rng.integers(0, 256, (H, W)).astype(np.uint8)
        cr = rng.integers(0, 256, (H, W)).astype(np.uint8)
    else:
        cl, cr = _extreme_pair(H, W, yc, xl, xr)
    got = _sad_packed(cl, cr, yc, xl, xr)
    plain = stereo_cuda.sad_windows_plain(
        *[torch.from_numpy(a) for a in (cl, cr, yc, xl, xr)]).numpy()
    pallas = np.asarray(sad_windows_pallas(
        *[jnp.asarray(a) for a in (cl, cr, yc, xl, xr)], interpret=True))
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, pallas)
    if fill == "extreme":
        # every term but the center's is 510 or 255: near the ceiling
        assert got.max() > 0.95 * _SAD_MAX


def _stereo_pair(h, w, shift, seed):
    import cv2

    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, size=(h, w + 64)).astype(np.float32)
    base = cv2.GaussianBlur(base, (5, 5), 1.2)
    for _ in range(120):
        y, x = rng.integers(10, h - 16), rng.integers(10, w + 40)
        base[y:y + 8, x:x + 8] = rng.uniform(0, 255)
    left = np.clip(base[:, 32:32 + w], 0, 255).astype(np.uint8)
    right = np.clip(base[:, 32 + shift:32 + shift + w], 0, 255).astype(np.uint8)
    return left, right


@pytest.fixture(scope="module")
def jax_extract():
    """One jitted JAX extractor (200x320, 600 features, 4 levels) shared by
    the cases, so it compiles once."""
    cfg = ORBConfig(n_features=600, n_levels=4, ini_th_fast=20, min_th_fast=7)
    ext = jext.OrbExtractor(cfg, 200, 320)

    def run(pair):
        levels = jpyr.build_pyramid(pair, ext.shapes)
        return ext.extract_from_pyramid_batched(levels, return_canvas=True)

    return cfg, ext, jax.jit(run)


@pytest.mark.parametrize("shift", [12, 20])
def test_match_stereo_matches_jax(shift, jax_extract, tmp_path):
    cfg, ext, run = jax_extract
    left, right = _stereo_pair(200, 320, shift, seed=shift)
    kb, canvas = run(jnp.asarray(np.stack([left, right])))
    kb = [np.asarray(a) for a in kb]
    canvas = np.asarray(canvas)
    offs = np.cumsum([0] + [s[0] for s in ext.shapes[:-1]]).astype(np.int32)
    widths = np.array([s[1] for s in ext.shapes], np.int32)
    sf = cfg.scale_factors().astype(np.float32)
    bf, baseline = 386.1448, 386.1448 / 718.856
    names = ("xy", "octave", "desc", "valid")
    idx = [jext.Keypoints._fields.index(f) for f in names]
    kl = [kb[i][0] for i in idx]
    kr = [kb[i][1] for i in idx]

    ref = run_reference(
        "match_stereo", tmp_path, xyL=kl[0], octL=kl[1], descL=kl[2],
        validL=kl[3], xyR=kr[0], octR=kr[1], descR=kr[2], validR=kr[3],
        canvasL=canvas[0], canvasR=canvas[1], offsets=offs, widths=widths,
        scales=sf, bf=bf, min_z=baseline)
    u, d = tstereo.match_stereo(
        *[torch.from_numpy(np.array(a)) for a in kl],
        *[torch.from_numpy(np.array(a)) for a in kr],
        torch.from_numpy(canvas[0].copy()), torch.from_numpy(canvas[1].copy()),
        torch.from_numpy(offs), torch.from_numpy(widths), torch.from_numpy(sf),
        bf, baseline)
    matched = ref["u_right"] >= 0
    assert matched.sum() > 50
    np.testing.assert_array_equal(u.numpy(), ref["u_right"])
    np.testing.assert_array_equal(d.numpy(), ref["depth"])
    disp = kl[0][matched, 0] - ref["u_right"][matched]
    assert abs(np.median(disp) - shift) < 0.5


def test_flatten_pyramid_matches_jax():
    rng = np.random.default_rng(4)
    levels = [rng.integers(0, 256, (2, h, w), dtype=np.uint8)
              for h, w in ((40, 60), (33, 50), (28, 42))]
    ref, roff = jstereo.flatten_pyramid([jnp.asarray(l) for l in levels])
    got, goff = tstereo.flatten_pyramid([torch.from_numpy(l) for l in levels])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(goff, roff)
