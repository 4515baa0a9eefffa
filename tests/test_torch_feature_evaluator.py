"""Port parity: the supervised feature scoring (introspection/
feature_evaluator.py), the GP heatmaps (ops/gp.py), the unsupervised
quality labels (introspection/unsupervised.py) and the dataset writer
(introspection/dataset_creator.py) against the JAX package, on seeded
inputs (tests/test_introspection.py's two-view geometry: K = 500 px, points
5-30 m away, a 0.4 m relative motion with a turn).

Tolerances (JAX's own tests state none for these comparisons):
* epipolar_scores, shared and per-keypoint transforms, with and without a
  pose covariance, 2 px of match noise and 20 corrupted matches: the valid
  set exact, raw and normalized errors, variances and feet within 1e-5
  relative + 1e-5 (float32 small-matrix algebra summed in another order;
  2e-6 relative seen);
* relative_transform, gt_reprojection_errors and
  map_point_reprojection_errors: within 1e-5 relative + 1e-4 (pixel
  errors of points 5-30 m away; the valid sets exact);
* rel_pose_cov_from_uncertainty, bad_match_stats, frame_good_for_training
  and the unsupervised functions: exact (host numpy and scipy, or counts);
* gp_grid_predict (512 padded points, 256 valid): mean within 1e-4 and
  variance within 1e-2 (its value is s_f^2 = 6400 minus a sum that nearly
  cancels it: 1e-2 is 2e-6 of s_f^2; the float32 Cholesky factor of the
  512x512 kernel matrix differs between LAPACK and XLA by rounding);
  heatmap_from_grid within 1 of 255 (the rounded uint8 map), equal on
  more than 99% of its pixels;
  hist2d_heatmap within 1e-6; mask_from_variance exact; a kernel matrix
  that is not positive definite gives NaN in both, without raising;
* DatasetCreator: keypoints.json, img_names.json and both CSVs byte for
  byte, and the PNG pixels equal to the reference writer's (imageio).
"""

import json
import os

import imageio.v3 as iio
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv_slam_tpu.geometry import se3 as jse3
from iv_slam_tpu.introspection import dataset_creator as jdc
from iv_slam_tpu.introspection import feature_evaluator as jfe
from iv_slam_tpu.introspection import unsupervised as junsup
from iv_slam_tpu.ops import gp as jgp
from iv_slam_tpu_torch.introspection import dataset_creator as tdc
from iv_slam_tpu_torch.introspection import feature_evaluator as tfe
from iv_slam_tpu_torch.introspection import unsupervised as tunsup
from iv_slam_tpu_torch.ops import gp as tgp
from torch_parity import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def geometry(rng, n=96, noise=2.0):
    X = np.stack([rng.uniform(-5, 5, n), rng.uniform(-3, 3, n),
                  rng.uniform(5, 30, n)], axis=1).astype(np.float32)
    T_rel = np.asarray(jse3.se3_exp(jnp.asarray(
        np.array([0.02, -0.04, 0.01, 0.3, 0.1, 0.2], np.float32))))

    def project(P):
        return np.stack([K[0, 0] * P[:, 0] / P[:, 2] + K[0, 2],
                         K[1, 1] * P[:, 1] / P[:, 2] + K[1, 2]], axis=1)

    kp_ref = project(X)
    kp_cur = project(X @ T_rel[:3, :3].T + T_rel[:3, 3]) + noise * rng.normal(size=(n, 2))
    kp_cur[:20] += rng.uniform(15, 40, (20, 2)) * rng.choice([-1, 1], (20, 2))
    return X, T_rel.astype(np.float32), kp_ref.astype(np.float32), kp_cur.astype(np.float32)


def close(got, want, rtol, atol, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("per_point", [False, True])
@pytest.mark.parametrize("cov", [False, True])
def test_epipolar_scores_match_jax(rng, per_point, cov):
    X, T_rel, kp_ref, kp_cur = geometry(rng)
    n = len(X)
    sig = (1.2 ** rng.integers(0, 4, n)) ** 2
    valid = rng.uniform(size=n) < 0.9
    if per_point:
        # per keypoint: the shared motion, or a short baseline (rejected)
        T_rel = np.repeat(T_rel[None], n, axis=0)
        T_rel[::7, :3, 3] *= 0.05
    sw = np.diag([2e-5, 3e-5, 1e-5]).astype(np.float32) if cov else np.zeros((3, 3), np.float32)
    st = np.diag([4e-3, 1e-3, 2e-3]).astype(np.float32) if cov else np.zeros((3, 3), np.float32)
    args = (kp_ref, kp_cur, sig.astype(np.float32), valid, T_rel, K, sw, st, np.bool_(cov))
    ref = jfe.epipolar_scores(*(jnp.asarray(a) for a in args))
    got = tfe.epipolar_scores(*(t(a) for a in args))
    np.testing.assert_array_equal(got.norm_err.numpy() >= 0, np.asarray(ref.norm_err) >= 0)
    assert (got.norm_err.numpy() >= 0).sum() > 50
    for f in ("norm_err", "raw_err", "variance", "foot"):
        close(getattr(got, f), getattr(ref, f), 1e-5, 1e-5, f)
    pct_j, n_j = jfe.bad_match_stats(ref.norm_err)
    pct_t, n_t = tfe.bad_match_stats(got.norm_err)
    assert int(n_t) == int(n_j) and float(pct_t) == float(pct_j) > 10.0
    assert tfe.frame_good_for_training(float(pct_t), int(n_t)) == \
        jfe.frame_good_for_training(float(pct_j), int(n_j))


def test_reprojection_errors_match_jax(rng):
    X, T_rel, kp_ref, kp_cur = geometry(rng)
    n = len(X)
    Twc_ref = np.asarray(jse3.se3_exp(jnp.asarray(rng.normal(0, 0.3, 6).astype(np.float32))))
    Twc_cur = Twc_ref @ np.linalg.inv(T_rel).astype(np.float32)
    Tr_j = jfe.relative_transform(jnp.asarray(Twc_cur), jnp.asarray(Twc_ref))
    Tr_t = tfe.relative_transform(t(Twc_cur), t(Twc_ref))
    close(Tr_t, Tr_j, 1e-5, 1e-5, "relative_transform")
    gtd = np.where(rng.uniform(size=n) < 0.85, X[:, 2], -1.0).astype(np.float32)
    valid = rng.uniform(size=n) < 0.9
    args = (kp_ref, kp_cur, gtd, valid, T_rel, K)
    ej = jfe.gt_reprojection_errors(*(jnp.asarray(a) for a in args))
    et = tfe.gt_reprojection_errors(*(t(a) for a in args))
    np.testing.assert_array_equal(et.numpy() >= 0, np.asarray(ej) >= 0)
    close(et, ej, 1e-5, 1e-4, "gt_reprojection_errors")
    # map-point variant: world points seen from an estimated reference pose
    T_ref_cw = np.linalg.inv(Twc_ref).astype(np.float32)
    pw = (X @ Twc_ref[:3, :3].T + Twc_ref[:3, 3]).astype(np.float32)
    T_ref_n = np.repeat(T_ref_cw[None], n, 0)
    T_gt_n = np.repeat(T_rel[None], n, 0)
    T_gt_n[-5:] = 0.0                       # padded slots: z = 0 guarded
    args = (kp_cur, pw, T_ref_n, T_gt_n, valid, K)
    (ej, pj), (et, pt) = (jfe.map_point_reprojection_errors(*(jnp.asarray(a) for a in args)),
                          tfe.map_point_reprojection_errors(*(t(a) for a in args)))
    np.testing.assert_array_equal(et.numpy() >= 0, np.asarray(ej) >= 0)
    close(et, ej, 1e-5, 1e-4, "map_point_reprojection_errors")
    ok = np.asarray(ej) >= 0
    np.testing.assert_allclose(pt.numpy()[ok], np.asarray(pj)[ok], rtol=1e-5, atol=1e-4)


def test_host_helpers_match_jax(rng):
    unc = rng.uniform(0.01, 1.0, (12, 2)).astype(np.float32)
    for ids in ((0, 11), (3, 5), (7, 2), (-1, 4), (2, 12)):
        a, b = tfe.rel_pose_cov_from_uncertainty(unc, *ids), \
            jfe.rel_pose_cov_from_uncertainty(unc, *ids)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
    for pct, cnt in ((5.0, 20), (5.1, 20), (59.9, 11), (60.0, 50), (30.0, 10)):
        assert tfe.frame_good_for_training(pct, cnt) == jfe.frame_good_for_training(pct, cnt)
    assert tfe.TRAINING_MODES == jfe.TRAINING_MODES
    for thresh in (1.0, 5.0):
        e = np.where(rng.uniform(size=300) < 0.2, -1.0,
                     rng.uniform(0, 8, 300)).astype(np.float32)
        pj, nj = jfe.bad_match_stats(jnp.asarray(e), thresh)
        pt, nt = tfe.bad_match_stats(t(e), thresh)
        assert int(nt) == int(nj) and float(pt) == float(pj)


def test_unsupervised_matches_jax(rng):
    n = 400
    chi2 = rng.exponential(3.0, n).astype(np.float32)
    dof = rng.choice([0, 2, 3], n).astype(np.int32)
    found = rng.integers(0, 6, n)
    for a, b in zip(tunsup.compute_keypt_qual_scores(chi2, dof, found),
                    junsup.compute_keypt_qual_scores(chi2, dof, found)):
        np.testing.assert_array_equal(a, b)
    q = rng.uniform(-0.9, 1.0, n).astype(np.float32)
    np.testing.assert_array_equal(tunsup.unsup_error_values(q), junsup.unsup_error_values(q))
    for _ in range(4):
        poses = [np.asarray(jse3.se3_exp(jnp.asarray(rng.normal(0, 0.4, 6).astype(np.float32))))
                 for _ in range(4)]
        e_t = tunsup.relative_pose_error(*poses)
        np.testing.assert_array_equal(e_t, junsup.relative_pose_error(*poses))
        for rel in (None, np.eye(4), poses[0]):
            for dt in (0.1, 1.0):
                assert tunsup.evaluate_tracking_accuracy(e_t * 0.01, rel, dt) == \
                    junsup.evaluate_tracking_accuracy(e_t * 0.01, rel, dt)


def gp_inputs(rng, cap=512, n=256, w=320, h=240):
    pts = np.zeros((cap, 2), np.float32)
    vals = np.zeros(cap, np.float32)
    valid = np.zeros(cap, bool)
    pts[:n] = np.stack([rng.uniform(0, w, n), rng.uniform(0, h, n)], 1)
    vals[:n] = np.where(pts[:n, 0] > 0.6 * w, rng.uniform(1.0, 3.0, n), rng.uniform(0, 0.5, n))
    valid[:n] = True
    return pts, vals, valid


def test_gp_matches_jax(rng):
    pts, vals, valid = gp_inputs(rng)
    bny, bnx, out_h, out_w = tgp.grid_shape(240, 320)
    assert (bny, bnx, out_h, out_w) == jgp.grid_shape(240, 320)
    mj, vj = jgp.gp_grid_predict(jnp.asarray(pts), jnp.asarray(vals), jnp.asarray(valid),
                                 bny, bnx)
    mt, vt = tgp.gp_grid_predict(t(pts), t(vals), t(valid), bny, bnx)
    close(mt, mj, 0, 1e-4, "mean")
    close(vt, vj, 0, 1e-2, "variance")
    for lo, hi in ((0.0, 1.5), (0.0, 1.0)):
        hj = np.asarray(jgp.heatmap_from_grid(mj, out_h, out_w, lo, hi)).astype(int)
        ht = tgp.heatmap_from_grid(mt, out_h, out_w, lo, hi).numpy()
        assert ht.dtype == np.uint8 and ht.shape == (out_h, out_w)
        d = np.abs(ht.astype(int) - hj)
        assert d.max() <= 1
        assert (d == 0).mean() > 0.99
    # the unsupervised mask: reliable (255) where the points are dense
    mj2 = np.asarray(jgp.mask_from_variance(vj, out_h, out_w))
    mt2 = tgp.mask_from_variance(vt, out_h, out_w).numpy()
    assert 0 < (mt2 == 255).mean() < 1, (mt2 == 255).mean()
    np.testing.assert_array_equal(mt2, mj2)


def test_gp_not_positive_definite_gives_nan(rng):
    """Two equal points and no observation noise: the kernel matrix is
    singular, the Cholesky factorization fails, and both packages return
    NaN (JAX's cholesky does; the port's must not raise)."""
    pts, vals, valid = gp_inputs(rng, cap=64, n=40)
    pts[1] = pts[0]
    bny, bnx, _, _ = tgp.grid_shape(240, 320)
    mj, vj = jgp.gp_grid_predict(jnp.asarray(pts), jnp.asarray(vals), jnp.asarray(valid),
                                 bny, bnx, s_n=0.0)
    mt, vt = tgp.gp_grid_predict(t(pts), t(vals), t(valid), bny, bnx, s_n=0.0)
    for a, b in ((mt, mj), (vt, vj)):
        np.testing.assert_array_equal(np.isnan(a.numpy()), np.isnan(np.asarray(b)))
    assert np.isnan(mt.numpy()).all()


def test_hist2d_heatmap_matches_jax(rng):
    pts, vals, valid = gp_inputs(rng)
    bny, bnx, _, _ = tgp.grid_shape(240, 320)
    hj = jgp.hist2d_heatmap(jnp.asarray(pts), jnp.asarray(vals), jnp.asarray(valid), bny, bnx)
    ht = tgp.hist2d_heatmap(t(pts), t(vals), t(valid), bny, bnx)
    close(ht, hj, 1e-6, 1e-6, "hist2d")


def test_dataset_creator_matches_jax(rng, tmp_path):
    out = {}
    for name, mod in (("jax", jdc), ("torch", tdc)):
        d = str(tmp_path / name)
        c = mod.DatasetCreator(d)
        r = np.random.default_rng(5)
        for i in range(3):
            k = int(r.integers(5, 40))
            c.append_keypoints(r.uniform(0, 300, (k, 2)).astype(np.float32),
                               np.zeros(k, np.float32), np.zeros(k, np.float32),
                               r.uniform(0, 3, k).astype(np.float32))
            desc = r.integers(0, 256, (k, 32), dtype=np.uint8)
            c.append_descriptors(desc, desc, f"{i:06d}.png")
            c.save_bad_region_heatmap(f"{i:06d}.png",
                                      r.integers(0, 256, (37, 61), dtype=np.uint8))
            c.save_bad_region_heatmap_mask(f"{i:06d}.png",
                                           np.where(r.uniform(size=(37, 61)) < 0.5, 0, 255))
        c.save_to_file()
        out[name] = d
    for f in ("keypoints.json", "img_names.json", "descriptors.csv", "descriptors_2.csv"):
        with open(os.path.join(out["torch"], f), "rb") as a, \
                open(os.path.join(out["jax"], f), "rb") as b:
            assert a.read() == b.read(), f
    json.load(open(os.path.join(out["torch"], "keypoints.json")))
    for sub in ("bad_region_heatmap", "bad_region_heatmap_mask"):
        names = sorted(os.listdir(os.path.join(out["jax"], sub)))
        assert names == sorted(os.listdir(os.path.join(out["torch"], sub))) and len(names) == 3
        for nm in names:
            a = iio.imread(os.path.join(out["torch"], sub, nm))
            b = iio.imread(os.path.join(out["jax"], sub, nm))
            assert a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(a, b)
