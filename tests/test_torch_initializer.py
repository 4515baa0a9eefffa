"""Port parity: the monocular initializer (solvers/initializer.py) and its
matcher (ops/match.py::search_for_initialization) against the JAX package.

* search_for_initialization on seeded two-view scenes holding duplicated
  keypoints (equal Hamming distances: the lower index must win, as
  ``lax.top_k`` picks it), both octaves and invalid keypoints, with and
  without the rotation check: every assignment and the count exact;
* initialize_mono on JAX's own 8-point draws (the (200, 8) indices JAX's
  ``jax.random.choice`` makes under PRNGKey(id), installed as the sampler):
  a noisy two-depth scene (the parallax case: the F model wins and is
  refused, as in the reference, whose F branch lists each essential
  decomposition twice, so that no F candidate is ever the one clearly best
  of initialize_mono's acceptance test), a noisy planar scene (the
  homography case, accepted) and a scene of too few points (refused). Every
  discrete outcome exact: ``ok``, H or F, the best homography hypothesis,
  the model inliers, the ``is_good`` set; the best fundamental hypothesis
  too, except on the plane, where each 8-point fundamental system has a
  3-dimensional null space and the hypothesis is whichever basis vector the
  library returns (both packages then choose H). R and t within 1e-4 and
  the points within 1e-3 relative to their depth: the port solves in
  float64 and rounds once, JAX solves in float32 (its SVDs agree with the
  port's to ~1e-6 here); the decomposition chosen is compared by value,
  since the SVD bases may order the candidates otherwise.

Tolerances are stated here, JAX's own tests state none for these functions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv_slam_tpu.ops import match as jmatch
from iv_slam_tpu.solvers import initializer as jinit
from iv_slam_tpu_torch.ops import match as tmatch
from iv_slam_tpu_torch.solvers import initializer as tinit
from torch_parity import jax_pnp_indices, one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

FX, FY, CX, CY, W, H = 400.0, 400.0, 160.0, 120.0, 320, 240
K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)


def jax_init_indices(key_id, valid, device=None):
    """The (200, 8) sample indices JAX's initialize_mono draws."""
    return jax_pnp_indices(key_id, valid, device, n_hyp=200, sample_size=8)


def rot(ax, ay, az):
    cx, sx, cy, sy, cz, sz = np.cos(ax), np.sin(ax), np.cos(ay), np.sin(ay), np.cos(az), np.sin(az)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (Rz @ Ry @ Rx).astype(np.float32)


def two_views(rng, n=400, planar=False, noise=0.5, n_valid=300):
    """Matched pixels (N, 2) of points seen from the origin and from a
    camera moved 0.6 m sideways and turned 2 degrees, with Gaussian pixel
    noise; the first n_valid rows are matches (some outliers among them),
    the rest zero rows as the tracker passes them."""
    X = np.stack([rng.uniform(-5, 5, n), rng.uniform(-3.5, 3.5, n),
                  np.full(n, 10.0) if planar else rng.choice([8.0, 12.0], n)
                  + rng.uniform(-1, 1, n)], 1)
    if planar:
        X[:, 2] += 0.1 * X[:, 0]
    R = rot(0.01, -0.03, 0.02)
    t = np.array([-0.6, 0.05, 0.02])
    X2 = X @ R.T + t
    p1 = np.stack([FX * X[:, 0] / X[:, 2] + CX, FY * X[:, 1] / X[:, 2] + CY], 1)
    p2 = np.stack([FX * X2[:, 0] / X2[:, 2] + CX, FY * X2[:, 1] / X2[:, 2] + CY], 1)
    p1 += rng.normal(0, noise, p1.shape)
    p2 += rng.normal(0, noise, p2.shape)
    out = rng.uniform(size=n) < 0.08
    p2[out] = rng.uniform([0, 0], [W, H], (out.sum(), 2))
    valid = np.arange(n) < n_valid
    p1 = np.where(valid[:, None], p1, 0.0).astype(np.float32)
    p2 = np.where(valid[:, None], p2, 0.0).astype(np.float32)
    return p1, p2, valid


@jax.jit
def jax_hypotheses(p1, p2, valid, idx):
    """JAX's best homography / fundamental hypothesis indices and the
    model's inliers, as initialize_mono computes them."""
    p1n, T1 = jinit._normalize(p1)
    p2n, T2 = jinit._normalize(p2)
    Hs = jax.vmap(lambda s: jnp.linalg.inv(T2) @ jinit._dlt_h(p1n[s], p2n[s]) @ T1)(idx)
    Fs = jax.vmap(lambda s: T2.T @ jinit._dlt_f(p1n[s], p2n[s]) @ T1)(idx)
    sh = jax.vmap(lambda h: jinit._score_h(h, p1, p2, valid)[0])(Hs)
    sf = jax.vmap(lambda f: jinit._score_f(f, p1, p2, valid)[0])(Fs)
    bh, bf = jnp.argmax(sh), jnp.argmax(sf)
    use_h = sh[bh] / jnp.maximum(sh[bh] + sf[bf], 1e-9) > 0.40
    inl = jnp.where(use_h, jinit._score_h(Hs[bh], p1, p2, valid)[1],
                    jinit._score_f(Fs[bf], p1, p2, valid)[1])
    return bh, bf, inl


@pytest.mark.parametrize("case", ["depths", "plane", "few"])
def test_initialize_mono_on_jax_draws(case):
    rng = np.random.default_rng({"depths": 1, "plane": 2, "few": 3}[case])
    p1, p2, valid = two_views(rng, planar=case == "plane",
                              n_valid=40 if case == "few" else 300)
    key = {"depths": 7, "plane": 8, "few": 9}[case]
    ref = jinit.initialize_mono(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid),
                                jnp.asarray(K), jax.random.PRNGKey(key))
    idx = jax_init_indices(key, valid)
    bh, bf, inl = jax_hypotheses(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid),
                                 jnp.asarray(idx.numpy()))
    got = tinit.initialize_mono(torch.from_numpy(p1), torch.from_numpy(p2),
                                torch.from_numpy(valid), torch.from_numpy(K), idx)
    assert bool(got.ok) == bool(ref.ok) == (case == "plane")
    assert bool(got.used_homography) == bool(ref.used_homography) == (case == "plane")
    assert int(got.best_h) == int(bh)
    if case != "plane":
        assert int(got.best_f) == int(bf)
    if case == "few":
        return
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(inl))
    good = got.is_good.numpy()
    np.testing.assert_array_equal(good, np.asarray(ref.is_good))
    assert good.sum() > 200
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=0, atol=1e-4)
    pts, pts_j = got.points.numpy()[good], np.asarray(ref.points)[good]
    np.testing.assert_allclose(pts, pts_j, rtol=0, atol=1e-3 * np.abs(pts_j[:, 2:]).max())


def test_sample_init_draws_distinct_valid_matches():
    valid = np.zeros(500, bool)
    valid[np.random.default_rng(0).choice(500, 120, replace=False)] = True
    idx = tinit.sample_init(5, valid).numpy()
    assert idx.shape == (200, 8)
    assert valid[idx].all()
    assert all(len(set(r)) == 8 for r in idx.tolist())
    np.testing.assert_array_equal(idx, tinit.sample_init(5, valid).numpy())


def init_scene(rng, n=500, n_dup=40):
    """Frame-1 and frame-2 keypoints: frame 2 holds noisy shifted copies of
    most frame-1 keypoints (a few descriptor bits flipped, octave 0 or
    not), clutter, and duplicates (the same descriptor, a pixel away)."""
    xy1 = np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)], 1)
    desc1 = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    oct1 = np.where(rng.uniform(size=n) < 0.7, 0, rng.integers(1, 4, n))
    ang1 = rng.uniform(0, 360, n)
    seen = rng.uniform(size=n) < 0.85
    xy2 = xy1[seen] + rng.normal([12.0, -4.0], 6.0, (seen.sum(), 2))
    desc2 = desc1[seen].copy()
    for i, k in enumerate(rng.integers(0, 60, len(desc2))):
        bits = rng.choice(256, k, replace=False)
        np.bitwise_xor.at(desc2[i], bits // 8, (1 << (bits % 8)).astype(np.uint8))
    oct2 = np.where(rng.uniform(size=len(desc2)) < 0.9, oct1[seen], 0)
    ang2 = (ang1[seen] + 15 + rng.normal(0, 3, len(desc2))) % 360
    ang2[rng.uniform(size=len(ang2)) < 0.1] = rng.uniform(0, 360)
    dup = rng.choice(len(xy2), n_dup, replace=False)
    xy2 = np.concatenate([xy2, rng.uniform([0, 0], [W, H], (80, 2)),
                          xy2[dup] + rng.choice([-1.0, 1.0], (n_dup, 2))])
    desc2 = np.concatenate([desc2, rng.integers(0, 256, (80, 32), dtype=np.uint8), desc2[dup]])
    oct2 = np.concatenate([oct2, rng.integers(0, 4, 80), oct2[dup]])
    ang2 = np.concatenate([ang2, rng.uniform(0, 360, 80), ang2[dup]])
    perm = rng.permutation(len(xy2))
    f1 = (xy1.astype(np.float32), oct1.astype(np.int32), ang1.astype(np.float32), desc1,
          rng.uniform(size=n) < 0.95)
    f2 = (xy2[perm].astype(np.float32), oct2[perm].astype(np.int32),
          ang2[perm].astype(np.float32), desc2[perm], rng.uniform(size=len(perm)) < 0.95)
    return f1, f2


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("check_orientation", [True, False])
def test_search_for_initialization_matches_jax(seed, check_orientation):
    f1, f2 = init_scene(np.random.default_rng(seed))
    args = f1 + f2 + (f1[0],)
    consts = (np.float32(100.0 if seed == 0 else 20.0), np.float32(0.9))
    aj, nj = jmatch.search_for_initialization(*(jnp.asarray(a) for a in args + consts),
                                              check_orientation=check_orientation)
    at, nt = tmatch.search_for_initialization(*(torch.from_numpy(np.array(a))
                                                for a in args + consts),
                                              check_orientation=check_orientation)
    assert at.dtype == torch.int32 and nt.dtype == torch.int32
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    assert int(nt) == int(nj) > 100
