"""Port: the Sim3 and PnP solvers (solvers/sim3_solver.py, pnp.py,
sim3_opt.py, essential_graph.py) against the JAX package's, on
tests/test_sim3_and_solvers.py's problems.

The RANSACs are scored on the hypothesis indices JAX draws
(``torch_parity.jax_sim3_indices``/``jax_pnp_indices``), so the winning
hypothesis and its inlier set are exact. Continuous results carry stated
tolerances. The port solves Horn's eigenproblem, EPnP and the LM systems
in float64 and rounds once to float32; JAX solves in float32. So Horn's
R, t, s agree within 1e-5 (rotation entries, and translation relative to
the scene), a RANSAC's pose within 1e-4, the Sim3 LM within 1e-5 and the
essential graph within 1e-5. EPnP on 8 points agrees within 1e-4; on a
4-point minimal sample its approximations depend on the basis an
eigen-solver picks for an exactly 4-dimensional null space, so there the
port and JAX are held to the reference test's accuracy gate at about the
same rate, not to each other. The cross-device
checks (the same indices on the card) are in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from iv_slam_tpu.geometry import se3 as jse3
from iv_slam_tpu.geometry import sim3 as js3
from iv_slam_tpu.solvers import essential_graph as jeg
from iv_slam_tpu.solvers import pnp as jpnp
from iv_slam_tpu.solvers import sim3_opt as jopt
from iv_slam_tpu.solvers import sim3_solver as jsim
from iv_slam_tpu_torch.geometry import se3 as tse3
from iv_slam_tpu_torch.solvers import essential_graph as teg
from iv_slam_tpu_torch.solvers import pnp as tpnp
from iv_slam_tpu_torch.solvers import sim3_opt as topt
from iv_slam_tpu_torch.solvers import sim3_solver as tsim
from torch_parity import jax_pnp_indices, jax_sim3_indices, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

FX = FY = 500.0
CX, CY = 320.0, 240.0


def t(a):
    return torch.as_tensor(np.asarray(a))


def project(P):
    z = np.maximum(P[:, 2], 1e-9)
    return np.stack([FX * P[:, 0] / z + CX, FY * P[:, 1] / z + CY], axis=1).astype(np.float32)


def rand_sim3(rng, scale_range=(0.5, 2.0)):
    w = rng.normal(size=3)
    w = w / np.linalg.norm(w) * rng.uniform(0, 2.5)
    return np.concatenate([w, rng.normal(size=3),
                           [np.log(rng.uniform(*scale_range))]]).astype(np.float32)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_sim3_matches_jax(rng, fix_scale):
    for _ in range(4):
        S = js3.sim3_exp(jnp.asarray(rand_sim3(rng)))
        P1 = (rng.normal(size=(20, 3)) * 5).astype(np.float32)
        P2 = np.asarray(S.act(jnp.asarray(P1))) + rng.normal(0, 0.01, (20, 3)).astype(np.float32)
        Rj, tj, sj = jsim.horn_sim3(jnp.asarray(P1), jnp.asarray(P2), fix_scale)
        Rt, tt, st = tsim.horn_sim3(t(P1), t(P2), fix_scale)
        np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=0, atol=1e-5)
        np.testing.assert_allclose(float(st), float(sj), rtol=1e-5)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0,
                                   atol=1e-5 * (1 + np.abs(P2).max()))
        if not fix_scale:
            np.testing.assert_allclose(float(st), float(S.s), rtol=0.01)


def _ransac_problem(rng, n=60, S_xi=(0.1, -0.2, 0.05, 0.5, 1.0, -0.3, np.log(1.3))):
    """test_sim3_and_solvers.py::test_sim3_ransac_with_outliers: 12 of 60
    matches are outliers."""
    S = js3.sim3_exp(jnp.asarray(np.array(S_xi, np.float32)))
    P1 = np.stack([rng.uniform(-5, 5, n), rng.uniform(-3, 3, n),
                   rng.uniform(4, 20, n)], axis=1).astype(np.float32)
    P2 = np.array(S.act(jnp.asarray(P1)))
    P2[:12] += rng.uniform(2, 5, (12, 3))
    return S, P1, P2, project(P1), project(np.asarray(S.act(jnp.asarray(P1))))


def _assert_same_ransac(rt, rj, atol):
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers)
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), rtol=0, atol=atol)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), rtol=0, atol=atol * 10)
    np.testing.assert_allclose(float(rt.s), float(rj.s), rtol=0, atol=atol)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_ransac_on_jax_indices(rng, fix_scale):
    S, P1, P2, uv1, uv2 = _ransac_problem(rng)
    n = len(P1)
    key = 0
    rj = jsim.sim3_ransac(jnp.asarray(P1), jnp.asarray(P2), jnp.asarray(uv1), jnp.asarray(uv2),
                          jnp.ones(n), jnp.ones(n, bool), FX, FY, CX, CY,
                          jax.random.PRNGKey(key), n_hyp=128, fix_scale=fix_scale)
    rt = tsim.sim3_ransac(t(P1), t(P2), t(uv1), t(uv2), torch.ones(n),
                          torch.ones(n, dtype=torch.bool), FX, FY, CX, CY,
                          jax_sim3_indices(key, 128, n), fix_scale=fix_scale)
    _assert_same_ransac(rt, rj, 1e-4)
    if not fix_scale:
        assert int(rt.n_inliers) >= 40 and not rt.inliers[:12].any()
        np.testing.assert_allclose(float(rt.s), float(S.s), rtol=0.05)


def test_sim3_ransac_valid_prefix_padding(rng):
    """test_sim3_and_solvers.py:82: 40 real matches padded to 1024 rows,
    hypotheses drawn from the prefix [0, 40) (also by the port's own
    sampler): every real match is an inlier, no padding row is."""
    S = js3.sim3_exp(jnp.asarray(np.array([0.05, -0.1, 0.02, 0.3, 0.6, -0.2, 0.0], np.float32)))
    m, N = 40, 1024
    P1 = np.zeros((N, 3), np.float32)
    P2 = np.zeros((N, 3), np.float32)
    P1[:m] = np.stack([rng.uniform(-5, 5, m), rng.uniform(-3, 3, m),
                       rng.uniform(4, 20, m)], axis=1)
    P2[:m] = np.asarray(S.act(jnp.asarray(P1[:m])))
    uv1, uv2 = project(P1), project(P2)
    validp = np.zeros(N, bool)
    validp[:m] = True
    rj = jsim.sim3_ransac(jnp.asarray(P1), jnp.asarray(P2), jnp.asarray(uv1), jnp.asarray(uv2),
                          jnp.ones(N), jnp.asarray(validp), FX, FY, CX, CY,
                          jax.random.PRNGKey(3), n_hyp=256, fix_scale=True, n_valid=np.int32(m))
    args = (t(P1), t(P2), t(uv1), t(uv2), torch.ones(N), t(validp), FX, FY, CX, CY)
    rt = tsim.sim3_ransac(*args, jax_sim3_indices(3, 256, m), fix_scale=True)
    _assert_same_ransac(rt, rj, 1e-4)
    own = tsim.sim3_ransac(*args, tsim.sample_sim3(3, 256, m, "cpu"), fix_scale=True)
    for r in (rt, own):
        assert int(r.n_inliers) == m and not r.inliers[m:].any()
        np.testing.assert_allclose(r.R.numpy(), np.asarray(S.R), atol=1e-3)
    idx = tsim.sample_sim3(3, 256, m, "cpu")
    assert idx.shape == (256, 3) and int(idx.min()) >= 0 and int(idx.max()) < m


def _pnp_problem(rng, n=80):
    """test_sim3_and_solvers.py::test_pnp_ransac: 15 of 80 outliers."""
    T = jse3.se3_exp(jnp.asarray(np.array([0.1, 0.2, -0.1, 0.3, -0.2, 0.5], np.float32)))
    Xw = np.stack([rng.uniform(-10, 10, n), rng.uniform(-5, 5, n),
                   rng.uniform(5, 40, n)], axis=1).astype(np.float32)
    uv = project(np.asarray(jse3.transform_points(T, jnp.asarray(Xw))))
    uv[:15] += rng.uniform(20, 60, (15, 2))
    return np.asarray(T), Xw, uv


@pytest.mark.parametrize("n_valid", [80, 50])
def test_pnp_ransac_on_jax_indices(rng, n_valid):
    T, Xw, uv = _pnp_problem(rng)
    n = len(Xw)
    valid = np.arange(n) < n_valid
    key = 1
    rj = jpnp.pnp_ransac(jnp.asarray(Xw), jnp.asarray(uv), jnp.ones(n), jnp.asarray(valid),
                         FX, FY, CX, CY, jax.random.PRNGKey(key), n_hyp=200)
    idx = jax_pnp_indices(key, valid, n_hyp=200)
    rt = tpnp.pnp_ransac(t(Xw), t(uv), torch.ones(n), t(valid), FX, FY, CX, CY, idx)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers) and bool(rt.ok) == bool(rj.ok) is True
    np.testing.assert_allclose(rt.T.numpy(), np.asarray(rj.T), rtol=0, atol=1e-4)
    assert not rt.inliers[:15].any()
    err = np.asarray(jse3.se3_log(jnp.asarray(rt.T.numpy()) @ jse3.inverse(jnp.asarray(T))))
    assert np.abs(err).max() < 0.02
    own = tpnp.sample_pnp(key, valid, n_hyp=200)
    assert own.shape == (200, 4) and bool((own < n_valid).all())
    assert all(len(set(row)) == 4 for row in own.tolist())


def _noisy_pnp_problem(seed):
    """_pnp_problem with 1 px Gaussian noise on every inlier."""
    rng = np.random.default_rng(100 + seed)
    T, Xw, uv = _pnp_problem(rng)
    uv[15:] += rng.normal(0.0, 1.0, uv[15:].shape).astype(np.float32)
    return T, Xw, uv


def _inlier_counts(Ts, Xw, uv):
    """pnp_ransac's score of each pose in Ts (sigma2 = 1), in numpy."""
    pc = Xw[None] @ Ts[:, :3, :3].transpose(0, 2, 1) + Ts[:, None, :3, 3]
    z = pc[..., 2]
    zs = np.maximum(z, 1e-9)
    e2 = (FX * pc[..., 0] / zs + CX - uv[None, :, 0]) ** 2 + \
        (FY * pc[..., 1] / zs + CY - uv[None, :, 1]) ** 2
    return ((z > 0) & (e2 < 5.991)).sum(1)


def test_pnp_ransac_epnp_noisy_on_jax_indices():
    """4-point EPnP hypotheses on noisy correspondences, JAX's 200 samples
    of each of 8 seeds. The kernel of a 4-point EPnP system is exactly
    4-dimensional, so each hypothesis depends on the basis the
    eigen-solver returns for it: the port's and JAX's hypotheses differ on
    most samples (over 85% of them by more than 1e-3 here), and the winning
    inlier sets cannot be held exactly. Held instead: every winner of
    either package is a usable pose (se3 error below 0.1, the noiseless
    test's gate being 0.02), the winners' inlier counts summed over the
    seeds are within 2% of JAX's, and over the outlier-free samples the
    port's hypotheses score at least 80% of JAX's on average."""
    win_t = win_j = 0
    score_t, score_j = [], []
    for seed in range(8):
        T, Xw, uv = _noisy_pnp_problem(seed)
        n = len(Xw)
        valid = np.ones(n, bool)
        rj = jpnp.pnp_ransac(jnp.asarray(Xw), jnp.asarray(uv), jnp.ones(n),
                             jnp.asarray(valid), FX, FY, CX, CY, jax.random.PRNGKey(seed),
                             n_hyp=200)
        idx = jax_pnp_indices(seed, valid, n_hyp=200)
        rt = tpnp.pnp_ransac(t(Xw), t(uv), torch.ones(n), t(valid), FX, FY, CX, CY, idx)
        assert bool(rt.ok) and bool(rj.ok)
        assert _se3_err(rt.T.numpy(), T) < 0.1 and _se3_err(np.asarray(rj.T), T) < 0.1
        win_t += int(rt.n_inliers)
        win_j += int(rj.n_inliers)
        ix = idx.numpy()
        uv_n = np.stack([(uv[:, 0] - CX) / FX, (uv[:, 1] - CY) / FY], 1).astype(np.float32)
        Tt = tpnp._epnp_pose(t(Xw)[idx], t(uv_n)[idx]).numpy()
        Tj = np.asarray(jax.jit(jax.vmap(jpnp._epnp_pose))(jnp.asarray(Xw[ix]),
                                                           jnp.asarray(uv_n[ix])))
        clean = (ix >= 15).all(1)
        ct = _inlier_counts(Tt, Xw, uv)
        assert ct.max() == int(rt.n_inliers)
        score_t.extend(ct[clean])
        score_j.extend(_inlier_counts(Tj, Xw, uv)[clean])
    assert abs(win_t - win_j) <= 0.02 * win_j, (win_t, win_j)
    assert np.mean(score_t) >= 0.8 * np.mean(score_j), (np.mean(score_t), np.mean(score_j))


def _se3_err(T_est, T):
    """max |se3_log(T_est T^-1)| (the reference test's error)."""
    D = torch.as_tensor(np.asarray(T_est) @ np.linalg.inv(np.asarray(T)), dtype=torch.float32)
    return float(tse3.se3_log(D).abs().max())


def test_epnp_minimal_sample(rng):
    """test_sim3_and_solvers.py::test_epnp_minimal_sample's 8 points give a
    near-exact pose, equal to JAX's within 1e-4. On 4 points the null space
    of M^T M is exactly 4-dimensional, so the beta approximations depend on
    which basis the eigen-solver returns for it, and every solver returns
    its own: over 40 seeded 4-point samples the port gives a usable pose
    (the reference test's gate, 0.5), solving them as one batch as
    pnp_ransac does, about as often as JAX does."""
    T = jse3.se3_exp(jnp.asarray(np.array([-0.2, 0.1, 0.25, -0.4, 0.6, 0.3], np.float32)))
    n = 8
    Xw = np.stack([rng.uniform(-8, 8, n), rng.uniform(-4, 4, n),
                   rng.uniform(4, 30, n)], axis=1).astype(np.float32)
    pc = np.asarray(jse3.transform_points(T, jnp.asarray(Xw)))
    uv_n = (pc[:, :2] / pc[:, 2:3]).astype(np.float32)
    T8t = tpnp._epnp_pose(t(Xw), t(uv_n)).numpy()
    T8j = np.asarray(jax.jit(jpnp._epnp_pose)(jnp.asarray(Xw), jnp.asarray(uv_n)))
    np.testing.assert_allclose(T8t, T8j, rtol=0, atol=1e-4)
    assert _se3_err(T8t, T) < 5e-3
    good_t = good_j = 0
    X4, uv4, T4 = [], [], []
    for seed in range(40):
        r = np.random.default_rng(seed)
        Ts = tse3.se3_exp(torch.as_tensor(r.normal(size=6).astype(np.float32) * 0.3)).numpy()
        X = np.stack([r.uniform(-8, 8, 4), r.uniform(-4, 4, 4), r.uniform(4, 30, 4)],
                     axis=1).astype(np.float32)
        p = X @ Ts[:3, :3].T + Ts[:3, 3]
        u = (p[:, :2] / p[:, 2:3]).astype(np.float32)
        X4.append(X)
        uv4.append(u)
        T4.append(Ts)
    batched = tpnp._epnp_pose(t(np.stack(X4)), t(np.stack(uv4))).numpy()
    batched_j = np.asarray(jax.jit(jax.vmap(jpnp._epnp_pose))(jnp.asarray(np.stack(X4)),
                                                              jnp.asarray(np.stack(uv4))))
    for i in range(40):
        good_t += _se3_err(batched[i], T4[i]) < 0.5
        good_j += _se3_err(batched_j[i], T4[i]) < 0.5
    assert good_j >= 16 and good_t >= good_j - 2, (good_t, good_j)


def test_dlt_pose_matches_jax(rng):
    """The 6-point DLT hypothesis solver (pnp_ransac's solver="dlt") on 8
    exact correspondences: equal to JAX's within 1e-4, and to the true pose."""
    T = jse3.se3_exp(jnp.asarray(np.array([0.15, -0.1, 0.2, 0.5, -0.3, 0.4], np.float32)))
    Xw = np.stack([rng.uniform(-8, 8, 8), rng.uniform(-4, 4, 8), rng.uniform(4, 30, 8)],
                  axis=1).astype(np.float32)
    pc = np.asarray(jse3.transform_points(T, jnp.asarray(Xw)))
    uv_n = (pc[:, :2] / pc[:, 2:3]).astype(np.float32)
    Tt = tpnp._dlt_pose(t(Xw), t(uv_n)).numpy()
    Tj = np.asarray(jax.jit(jpnp._dlt_pose)(jnp.asarray(Xw), jnp.asarray(uv_n)))
    np.testing.assert_allclose(Tt, Tj, rtol=0, atol=1e-4)
    assert _se3_err(Tt, T) < 5e-3


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_sim3_matches_jax(rng, fix_scale):
    """optimize_sim3 from a perturbed RANSAC start over 60 matches (12
    outliers), padded to 64 rows: the same inliers, S within 1e-5."""
    S, P1, P2, uv1, uv2 = _ransac_problem(rng)
    if fix_scale:
        S2 = js3.sim3_exp(jnp.asarray(np.array([0.1, -0.2, 0.05, 0.5, 1.0, -0.3, 0.0],
                                               np.float32)))
        P2 = np.array(S2.act(jnp.asarray(P1)))
        P2[:12] += rng.uniform(2, 5, (12, 3))
        uv2 = project(np.asarray(S2.act(jnp.asarray(P1))))
        S = S2
    n, N = len(P1), 64
    pad = lambda a: np.concatenate([a, np.zeros((N - n,) + a.shape[1:], a.dtype)])  # noqa: E731
    inv1 = np.ones(N, np.float32)
    inv2 = np.full(N, 1.0 / 1.44, np.float32)
    valid = np.arange(N) < n
    # S21 (frame 2 points into frame 1) from a perturbed start, as
    # loop closing refines the RANSAC's S over the union of matches
    Sinv = S.inverse()
    R0 = np.asarray(Sinv.R)
    t0 = (np.asarray(Sinv.t) + 0.05).astype(np.float32)
    s0 = np.float32(float(Sinv.s) * (1.0 if fix_scale else 1.02))
    args_np = (pad(P1), pad(P2), pad(uv1), pad(uv2), inv1, inv2, valid)
    oj = jopt.optimize_sim3(jnp.asarray(R0), jnp.asarray(t0), jnp.float32(s0),
                            *(jnp.asarray(a) for a in args_np), FX, FY, CX, CY,
                            fix_scale=fix_scale)
    ot = topt.optimize_sim3(t(R0), t(t0), torch.tensor(s0), *(t(a) for a in args_np),
                            FX, FY, CX, CY, fix_scale=fix_scale)
    np.testing.assert_array_equal(ot.inliers.numpy(), np.asarray(oj.inliers))
    assert int(ot.n_inliers) == int(oj.n_inliers) == 48
    np.testing.assert_allclose(ot.R.numpy(), np.asarray(oj.R), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ot.t.numpy(), np.asarray(oj.t), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(ot.s), float(oj.s), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(ot.s), float(Sinv.s), rtol=1e-3)


def _eg_problem(rng, K=12):
    """test_sim3_and_solvers.py::test_essential_graph_closes_loop: a
    12-keyframe circle with drifted odometry and one loop edge."""
    gt = []
    for k in range(K):
        ang = 2 * np.pi * k / K
        xi = np.array([0, 0.05 * k, 0, np.cos(ang), np.sin(ang), 0.0], np.float32)
        gt.append(np.asarray(jse3.se3_exp(jnp.asarray(xi))))
    est = [gt[0]]
    for k in range(1, K):
        rel = np.linalg.inv(gt[k - 1]) @ gt[k]
        noise = jse3.se3_exp(jnp.asarray(
            (rng.normal(size=6) * np.array([0.01] * 3 + [0.02] * 3)).astype(np.float32)))
        est.append(est[-1] @ np.asarray(noise) @ rel)
    e_i, e_j, e_R, e_t = [], [], [], []
    pairs = [(k - 1, k) for k in range(1, K)] + [(K - 1, 0)]
    for a, b in pairs:
        Sji = np.linalg.inv(np.linalg.inv(gt[a]) @ gt[b])
        e_i.append(a)
        e_j.append(b)
        e_R.append(Sji[:3, :3])
        e_t.append(Sji[:3, 3])
    E = len(e_i)
    return gt, dict(
        R=np.stack([np.linalg.inv(T)[:3, :3] for T in est]).astype(np.float32),
        t=np.stack([np.linalg.inv(T)[:3, 3] for T in est]).astype(np.float32),
        s=np.ones(K, np.float32), fixed=np.arange(K) == 0,
        e_i=np.array(e_i, np.int32), e_j=np.array(e_j, np.int32),
        e_R=np.stack(e_R).astype(np.float32), e_t=np.stack(e_t).astype(np.float32),
        e_s=np.ones(E, np.float32), e_valid=np.ones(E, bool))


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_essential_graph_matches_jax(rng, fix_scale):
    gt, prob = _eg_problem(rng)
    Rj, tj, sj = jeg.optimize_essential_graph(
        jeg.EGProblem(**{k: jnp.asarray(v) for k, v in prob.items()}), n_iters=8,
        fix_scale=fix_scale)
    Rt, tt, st = teg.optimize_essential_graph(
        teg.EGProblem(**{k: t(v) for k, v in prob.items()}), n_iters=8, fix_scale=fix_scale)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-5)
    errs = []
    for k in range(len(gt)):
        Tcw = np.eye(4)
        Tcw[:3, :3] = Rt[k].numpy()
        Tcw[:3, 3] = tt[k].numpy() / float(st[k])
        errs.append(np.linalg.norm(np.linalg.inv(Tcw)[:3, 3] - gt[k][:3, 3]))
    assert max(errs) < 0.05
