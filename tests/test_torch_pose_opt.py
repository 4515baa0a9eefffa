"""Port parity: solvers/pose_opt.py against the JAX package.

The problems are tests/test_pose_opt.py's scene (200 edges, 70% stereo, 10%
gross outliers) as it stands, and again with mono and stereo edges at four
octaves, quality scores below 1 and some edges not valid. The JAX side is
the jitted ``pose_optimization`` and ``_lm_round``, run without FMA
contraction (tests/torch_parity.py).

Tolerances: the pose within 1e-5, inlier sets and counts equal. chi2 is a
function of the pose: evaluated by the port at the reference's final pose
it must equal the reference's within rtol 1e-4 (a pose a few ulps away
moves the chi2 of a 45 px outlier by more than that).

The port runs an iteration's LM trials as one batch; ``_lm_round``'s trial
counts and poses must equal a plain statement of the reference's
sequential trial loop on every problem, one with iterations that need
more than one trial, one whose edges are all masked (NaN steps) included.

On the card ``pose_optimization`` is one launch of csrc/pose_lm.cu (held
bit-equal to the twin there by tests/test_torch_cuda.py). Here: a model of
that kernel's order of float32 additions for H and g equals
``numerics.tree_sum`` bit for bit, and on the CPU ``pose_optimization``
takes the twin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv_slam_tpu.geometry import camera as jcam
from iv_slam_tpu.geometry import se3 as jse3
from iv_slam_tpu.solvers import pose_opt as jpo
from iv_slam_tpu_torch import numerics
from iv_slam_tpu_torch.geometry import camera as tcam
from iv_slam_tpu_torch.geometry import se3 as tse3
from iv_slam_tpu_torch.solvers import pose_opt as tpo
from iv_slam_tpu_torch.solvers import pose_opt_cuda
from iv_slam_tpu_torch.utils import profiling
from test_pose_opt import make_scene
from torch_parity import run_reference

XI0 = np.array([0.01, 0.02, -0.015, 0.2, 0.1, -0.3], np.float32)


def as_t(a):
    return torch.from_numpy(np.array(a))


def problem(mixed: bool):
    """test_pose_opt.py's problem (its rng fixture's seed), or the same
    scene with per-octave information, quality < 1 and invalid edges."""
    rng = np.random.default_rng(42)
    K, Xw, obs, T_gt, out_idx = make_scene(rng)
    n = obs.shape[0]
    T0 = np.asarray(jse3.se3_exp(jnp.asarray(XI0)) @ T_gt)
    inv_s2, qual, valid = np.ones(n, np.float32), np.ones(n, np.float32), np.ones(n, bool)
    if mixed:
        inv_s2 = (1.0 / 1.2 ** (2 * rng.integers(0, 4, n))).astype(np.float32)
        qual = rng.uniform(0.3, 1.0, n).astype(np.float32)
        valid = rng.uniform(size=n) < 0.95
    return dict(T0=T0, Xw=np.asarray(Xw), obs=np.asarray(obs), inv_sigma2=inv_s2,
                qual=qual, valid=valid, K=np.array([float(v) for v in K], np.float32)), \
        np.asarray(T_gt), out_idx


def port_K(Kv):
    return tcam.Intrinsics(*(torch.tensor(v) for v in Kv))


def sequential_round(T0, Xw, obs, inv_s2, delta_sq, is_stereo, mask, K, kernel_on,
                     n_iters):
    """The reference's _lm_round (pose_opt.py:104-166), its trial
    while-loop kept as a loop, on the port's residuals and costs."""
    cost = lambda T: tpo._total_cost(T, Xw, obs, inv_s2, delta_sq, is_stereo,  # noqa: E731
                                     mask, K, kernel_on)
    T, chi = T0, cost(T0)
    trials = []
    for it in range(n_iters):
        H, g = tpo._normal_equations(T, Xw, obs, inv_s2, delta_sq, is_stereo, mask, K,
                                     kernel_on)
        if it == 0:
            lam, ni = 1e-5 * torch.diagonal(H).abs().amax(), torch.tensor(2.0)
        rho, k, done = torch.tensor(-1.0), 0, False
        while not done and bool(rho < 0) and k < tpo.MAX_TRIALS:
            dx = tpo._damped_step(H, lam.reshape(1), g)
            T_new = numerics.matmul(tse3.se3_exp(dx), T)[0]
            chi_new = cost(T_new)
            rho = (chi - chi_new) / tpo._gain_scale(dx, lam.reshape(1), g)[0]
            done = bool((rho > 0) & torch.isfinite(chi_new))
            if done:
                a = 2.0 * rho - 1.0
                T, chi = T_new, chi_new
                lam, ni = lam * torch.clamp(1.0 - a * a * a, 1.0 / 3.0, 2.0 / 3.0), \
                    torch.tensor(2.0)
            else:
                lam, ni = lam * ni, ni * 2.0
            k += 1
        trials.append(k)
    return T, trials


@pytest.mark.parametrize("mixed", [False, True], ids=["test_pose_opt", "mono-stereo-qual"])
def test_pose_optimization_matches_jax(tmp_path, mixed):
    inp, T_gt, out_idx = problem(mixed)
    ref = run_reference("pose_opt", tmp_path, n_rounds=4, n_iters=10, **inp)
    t = {k: as_t(v) for k, v in inp.items() if k != "K"}
    K = port_K(inp["K"])
    res = tpo.pose_optimization(t["T0"], t["Xw"], t["obs"], t["inv_sigma2"], t["qual"],
                                t["valid"], K)
    np.testing.assert_allclose(res.T.numpy(), ref["T"], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(res.inlier.numpy(), ref["inlier"])
    assert res.n_inliers.dtype == torch.int32
    assert int(res.n_inliers) == int(ref["n_inliers"])
    is_stereo = t["obs"][:, 2] >= 0
    e, _ = tpo._residuals(as_t(ref["T"]), t["Xw"], t["obs"], is_stereo, K)
    np.testing.assert_allclose(tpo._chi2(e, t["inv_sigma2"]).numpy(), ref["chi2"],
                               rtol=1e-4)
    # one robust round from T0: the port's batched trials against the
    # reference, and against the sequential trial loop
    delta_sq = torch.where(is_stereo, tpo.DELTA_STEREO_SQ, tpo.DELTA_MONO_SQ) \
        * t["qual"] * t["qual"]
    args = (t["T0"], t["Xw"], t["obs"], t["inv_sigma2"], delta_sq, is_stereo, t["valid"],
            K, True, 10)
    T_round, trials = tpo._lm_round(*args)
    np.testing.assert_allclose(T_round.numpy(), ref["T_round"], rtol=0, atol=1e-5)
    T_seq, trials_seq = sequential_round(*args)
    assert trials.tolist() == trials_seq
    assert torch.equal(T_round, T_seq)
    if mixed:
        assert max(trials_seq) > 1, trials_seq
    # test_pose_opt.py's own checks on the port
    err = tse3.se3_log(res.T @ tse3.inverse(as_t(T_gt))).numpy()
    assert np.abs(err[:3]).max() < 2e-4 and np.abs(err[3:]).max() < 5e-3, err
    inlier = res.inlier.numpy()
    assert not inlier[out_idx].any()
    assert inlier.sum() > 0.8 * (len(inlier) - len(out_idx)) * (0.9 if mixed else 1.0)


@pytest.mark.parametrize("case", ["far-start", "kernel-off", "all-masked"])
def test_batched_trials_equal_sequential_loop(case):
    inp, T_gt, _ = problem(True)
    t = {k: as_t(v) for k, v in inp.items() if k != "K"}
    if case == "far-start":
        t["T0"] = tse3.se3_exp(as_t(XI0 * 8)) @ as_t(T_gt)
    mask = torch.zeros_like(t["valid"]) if case == "all-masked" else t["valid"]
    is_stereo = t["obs"][:, 2] >= 0
    delta_sq = torch.where(is_stereo, 7.815, 5.991) * t["qual"] ** 2
    args = (t["T0"], t["Xw"], t["obs"], t["inv_sigma2"], delta_sq, is_stereo, mask,
            port_K(inp["K"]), case != "kernel-off", 10)
    T_round, trials = tpo._lm_round(*args)
    T_seq, trials_seq = sequential_round(*args)
    assert trials.tolist() == trials_seq
    assert torch.equal(T_round, T_seq)
    if case == "all-masked":
        assert torch.equal(T_round, t["T0"])


def test_damping_ladder_is_the_sequential_products():
    for lam0, ni0 in ((3.7e-4, 2.0), (1.5e3, 2.0 ** 9), (1e-30, 4.0), (2e30, 2.0 ** 20)):
        lam, ni = tpo._damping_ladder(torch.tensor(lam0, dtype=torch.float32),
                                      torch.tensor(ni0, dtype=torch.float32))
        want_l, want_n = [np.float32(lam0)], [np.float32(ni0)]
        with np.errstate(over="ignore"):
            for _ in range(tpo.MAX_TRIALS):
                want_l.append(want_l[-1] * want_n[-1])
                want_n.append(want_n[-1] * np.float32(2.0))
        np.testing.assert_array_equal(lam.numpy(), np.array(want_l, np.float32))
        np.testing.assert_array_equal(ni.numpy(), np.array(want_n, np.float32))


def test_jacobian_and_huber_match_jax(rng):
    inp, _, _ = problem(True)
    Kj = jcam.Intrinsics(*(jnp.float32(v) for v in inp["K"]))
    is_stereo = inp["obs"][:, 2] >= 0
    ej, pcj = jpo._residuals(jnp.asarray(inp["T0"]), jnp.asarray(inp["Xw"]),
                             jnp.asarray(inp["obs"]), jnp.asarray(is_stereo), Kj)
    et, pct = tpo._residuals(as_t(inp["T0"]), as_t(inp["Xw"]), as_t(inp["obs"]),
                             as_t(is_stereo), port_K(inp["K"]))
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=0, atol=1e-4)
    pc = np.asarray(pcj)
    np.testing.assert_array_equal(
        tpo._jacobian(as_t(pc), as_t(is_stereo), port_K(inp["K"])).numpy(),
        np.asarray(jpo._jacobian(jnp.asarray(pc), jnp.asarray(is_stereo), Kj)))
    chi2 = rng.uniform(0, 20, 64).astype(np.float32)
    dsq = (5.991 * rng.uniform(0.05, 1, 64) ** 2).astype(np.float32)
    # the port's sqrt is the rounded root (numerics.sqrt), as XLA's is
    for on in (True, False):
        np.testing.assert_array_equal(
            tpo._huber_w(as_t(chi2), as_t(dsq), on).numpy(),
            np.asarray(jpo._huber_w(jnp.asarray(chi2), jnp.asarray(dsq), on)))
        np.testing.assert_array_equal(
            tpo._huber_rho0(as_t(chi2), as_t(dsq), on).numpy(),
            np.asarray(jpo._huber_rho0(jnp.asarray(chi2), jnp.asarray(dsq), on)))


def kernel_tree_sum(x: np.ndarray) -> np.ndarray:
    """csrc/pose_lm.cu's column sums (phase B) over the (R, C) float32 rows:
    rows padded with zeros to P = 2^ceil(log2 R); S = min(P, 512) slots,
    slot j = l * W + w of lane l < L = min(S, 32) and warp w < W = S / L;
    each slot sums its rows k * S + j (k < P / S) as the evens' tree plus
    the odds' tree, then the lanes' tree by shuffles (v[l] + v[l + o],
    o = L/2 ... 1), then the warps' tree in shared memory (o = W/2 ... 1)."""
    R = x.shape[0]
    P = 1 << max(R - 1, 0).bit_length()
    S = min(P, 512)
    L = min(S, 32)
    W = S // L
    rows = np.zeros((P,) + x.shape[1:], np.float32)
    rows[:R] = x

    def local(k, step, m, j):
        if m == 1:
            return rows[k * S + j]
        return local(k, 2 * step, m // 2, j) + local(k + step, 2 * step, m // 2, j)

    slots = np.stack([local(0, 1, P // S, j) for j in range(S)]).reshape(L, W, -1)

    def shuffle_tree(v, n):
        o = n // 2
        while o > 0:
            v = v[:o] + v[o:2 * o]
            o //= 2
        return v[0]

    lanes = np.stack([shuffle_tree(slots[:, w], L) for w in range(W)])
    return shuffle_tree(lanes, W)


@pytest.mark.parametrize("n_edges", [1, 7, 1024, 1536, 2000])
def test_kernel_reduction_order_is_tree_sum(n_edges):
    """H and g's 42 columns over 3N rows: the kernel's order of float32
    additions is numerics.tree_sum's, bit for bit (signed zeros too), on
    rows spanning 12 decades with exact zeros and negative zeros, where
    another order of the same additions gives other sums."""
    rng = np.random.default_rng(n_edges)
    x = (rng.normal(size=(3 * n_edges, 42)) * 10.0 ** rng.integers(-6, 6, (3 * n_edges, 42))
         ).astype(np.float32)
    x[rng.uniform(size=x.shape) < 0.1] = 0.0
    x[rng.uniform(size=x.shape) < 0.05] = -0.0
    x[:, 0] = -0.0   # a column of negative zeros sums to +0 with the padding
    want = numerics.tree_sum(torch.from_numpy(x)).numpy()
    got = kernel_tree_sum(x)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if n_edges >= 7:   # the order matters on these rows
        seq = np.zeros(42, np.float32)
        for row in x:
            seq = seq + row
        assert not np.array_equal(seq, want)


def test_pose_optimization_on_the_cpu_is_the_twin():
    """CPU tensors take pose_optimization_plain: the same result, no kernel
    launch, and one pose_lm.plain span."""
    inp, _, _ = problem(True)
    t = {k: as_t(v) for k, v in inp.items() if k != "K"}
    K = port_K(inp["K"])
    args = (t["T0"], t["Xw"], t["obs"], t["inv_sigma2"], t["qual"], t["valid"], K)
    launches = pose_opt_cuda.launches
    timer = profiling.StageTimer()
    prev = profiling.install(timer)
    try:
        got = tpo.pose_optimization(*args, n_rounds=3, n_iters=7)
    finally:
        profiling.install(prev)
    ref = tpo.pose_optimization_plain(*args, n_rounds=3, n_iters=7)
    for f in tpo.PoseOptResult._fields:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert [sp[0] for sp in timer.spans] == ["pose_lm.plain"]
    assert pose_opt_cuda.launches == launches
