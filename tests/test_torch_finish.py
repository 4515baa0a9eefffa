"""Port parity: orientation + rBRIEF (the plain version of kernel 2 and the
wrapper's CPU dispatch) vs the JAX package.

Against the JAX CPU path (orient.ic_angles_integral then
brief.descriptors_onehot_mxu) angles and descriptors are exactly equal:
the moments are exact integers and fastAtan2 / the pattern rotation are the
same f32 operations. Against the Pallas finish kernel in interpret mode
the angles agree to atol=5e-3, the reference's own tolerance
(tests/test_finish_pallas.py: FMA contraction differs inside that kernel),
and descriptors are exactly equal when given the same angles.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iv_slam_tpu.ops import brief as jbrief
from iv_slam_tpu.ops import finish_pallas
from iv_slam_tpu.ops import image as jimage
from iv_slam_tpu.ops import orient as jorient
from iv_slam_tpu_torch.ops import brief as tbrief
from iv_slam_tpu_torch.ops import finish_cuda
from iv_slam_tpu_torch.ops import orient as torient


def _canvas(seed, h, w):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
    blur = np.array(jimage.gaussian_blur(jnp.asarray(raw), 7, 2.0))
    return rng, raw, blur


def _yx(rng, h, w, n):
    ys = rng.integers(19, h - 19, size=n)
    xs = rng.integers(19, w - 19, size=n)
    return np.stack([ys, xs], axis=1).astype(np.int32)


@pytest.mark.parametrize("h,w,n", [(120, 333, 77), (96, 256, 200)])
def test_orient_brief_exact_vs_jax_cpu_path(h, w, n):
    rng, raw, blur = _canvas(0, h, w)
    yx = _yx(rng, h, w, n)
    ang_ref = jorient.ic_angles_integral(jnp.asarray(raw), jnp.asarray(yx))
    desc_ref = jbrief.descriptors_onehot_mxu(jnp.asarray(blur), jnp.asarray(yx), ang_ref)
    ang, desc = finish_cuda.orient_brief(
        torch.from_numpy(raw), torch.from_numpy(blur), torch.from_numpy(yx))
    np.testing.assert_array_equal(ang.numpy(), np.asarray(ang_ref))
    np.testing.assert_array_equal(desc.numpy(), np.asarray(desc_ref))
    # the wrapper's CPU dispatch is exactly the plain version
    ang_p, desc_p = finish_cuda.orient_brief_plain(
        torch.from_numpy(raw), torch.from_numpy(blur), torch.from_numpy(yx))
    assert torch.equal(ang, ang_p) and torch.equal(desc, desc_p)


def test_orient_brief_canvas_edges_and_empty_vs_jax_cpu_path():
    """Keypoints 19 px from every edge and corner of the canvas, and N=0,
    through the wrapper's CPU dispatch: equal to the JAX CPU path."""
    h, w = 90, 140
    _, raw, blur = _canvas(4, h, w)
    near = lambda n: (19, n // 2, n - 20)
    yx = np.array([(r, c) for r in near(h) for c in near(w)], dtype=np.int32)
    for pts in (yx, yx[:0]):
        ang_ref = jorient.ic_angles_integral(jnp.asarray(raw), jnp.asarray(pts))
        desc_ref = jbrief.descriptors_onehot_mxu(jnp.asarray(blur), jnp.asarray(pts),
                                                 ang_ref)
        ang, desc = finish_cuda.orient_brief(
            torch.from_numpy(raw), torch.from_numpy(blur), torch.from_numpy(pts))
        assert ang.shape == (len(pts),) and desc.shape == (len(pts), 32)
        np.testing.assert_array_equal(ang.numpy(), np.asarray(ang_ref))
        np.testing.assert_array_equal(desc.numpy(), np.asarray(desc_ref))


def test_pattern_fits_the_kernel_window():
    """The rotated BRIEF pattern reaches at most finish_cuda.REACH px at
    any angle: checked here on the table, and over a sweep of angles by
    the plain rotation itself."""
    pat = tbrief.pattern()
    assert finish_cuda.pattern_reach(pat) == finish_cuda.REACH == 18
    ang = torch.linspace(0, 360, 7201, dtype=torch.float32)
    idx = tbrief.pattern_indices(1001, 1001, torch.full((len(ang), 2), 500,
                                                        dtype=torch.int32), ang)
    dr, dc = idx // 1001 - 500, idx % 1001 - 500
    assert int(dr.abs().max()) == 18 and int(dc.abs().max()) == 18


def test_brief_exact_at_arbitrary_angles():
    """Rotated-pattern rounding (rint at .5 boundaries) agrees with the JAX
    one-hot and flat-gather paths over many angles, negative ones included."""
    rng, _, blur = _canvas(1, 80, 200)
    n = 600
    yx = _yx(rng, 80, 200, n)
    ang = rng.uniform(-180, 360, size=n).astype(np.float32)
    ang[:8] = [0.0, 45.0, 90.0, 135.0, 180.0, 225.0, 270.0, 315.0]
    ref = np.asarray(jbrief.descriptors_onehot_mxu(
        jnp.asarray(blur), jnp.asarray(yx), jnp.asarray(ang)))
    ref2 = np.asarray(jbrief.descriptors_global_gather(
        jnp.asarray(blur), jnp.asarray(yx), jnp.asarray(ang)))
    got = tbrief.descriptors_global_gather(
        torch.from_numpy(blur), torch.from_numpy(yx), torch.from_numpy(ang)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, ref2)


def test_fast_atan2_exact():
    rng = np.random.default_rng(2)
    y = rng.integers(-200000, 200000, size=20000).astype(np.float32)
    x = rng.integers(-200000, 200000, size=20000).astype(np.float32)
    y[:6] = [0, 0, 5, -5, 7, -7]
    x[:6] = [0, 3, 0, 0, 7, -7]
    ref = np.asarray(jorient.fast_atan2_deg(jnp.asarray(y), jnp.asarray(x)))
    got = torient.fast_atan2_deg(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_tables_match_jax():
    np.testing.assert_array_equal(torient.umax_table(), jorient.umax_table())
    for a, b in zip(torient.moment_weights(), jorient.moment_weights()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tbrief.pattern(), jbrief.pattern())


def test_vs_pallas_finish_interpret():
    rng, raw, blur = _canvas(3, 120, 333)
    yx = _yx(rng, 120, 333, 77)
    ang_p, desc_p = finish_pallas.orient_brief_pallas(
        jnp.asarray(raw), jnp.asarray(blur), jnp.asarray(yx), interpret=True)
    ang, _ = finish_cuda.orient_brief(
        torch.from_numpy(raw), torch.from_numpy(blur), torch.from_numpy(yx))
    np.testing.assert_allclose(ang.numpy(), np.asarray(ang_p), atol=5e-3)
    desc_same = tbrief.descriptors_global_gather(
        torch.from_numpy(blur), torch.from_numpy(yx),
        torch.from_numpy(np.array(ang_p)))
    np.testing.assert_array_equal(desc_same.numpy(), np.asarray(desc_p))
