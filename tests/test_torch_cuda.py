"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them. The
main-path shapes are checked by chip_smoke.py; these cases cover the edges
it does not reach: tiny and odd image sizes and level lists mixing them,
keypoint counts that do not fill a block, keypoints 0-5 and 18-19 px
from the canvas edges, clip-limit window centers, SAD canvases that are
views at every byte offset mod 16, and the wrappers' refusals. The pose LM
kernel (csrc/pose_lm.cu) against its plain twin: table sizes 1 to 3,001
edges (shared-memory and scratch rows), mono and stereo edges, quality
below 1, gross outliers, rejected and all-rejected trials, every edge
masked, 2 and 4 rounds, and the two pose LMs of a real fused step. Beyond the
kernels: the vocabulary's device descent against the host descent on the
1M-leaf synthesized tree, the Sim3 RANSAC and the monocular initializer on
the card against the CPU path with the same sampled indices, and the
single-image extraction of the mono and RGB-D frontends at the EuRoC and
TUM sizes. This file imports no JAX, so it runs
where JAX is not installed:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from iv_slam_tpu_torch.ops import fast, fast_cuda, finish_cuda, image, stereo_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _u8(rng, *shape):
    return torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8))


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (7, 7), (33, 65), (2, 87, 203),
                                   (2, 376, 1241)])
@pytest.mark.parametrize("th", [0, 7, 20])
def test_fast_kernel_equals_plain(dev, shape, th):
    rng = np.random.default_rng(sum(shape) + th)
    img = image.gaussian_blur(_u8(rng, *shape), 7, 2.0) if min(shape[-2:]) > 3 \
        else _u8(rng, *shape)
    img = img.to(dev)
    before = fast_cuda.launches
    got = fast_cuda.fast_score(img, th)
    assert fast_cuda.launches == before + 1
    ref = fast.fast_score(img, th)
    torch.cuda.synchronize()
    assert got.dtype == torch.int16 and torch.equal(got, ref)


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("th", [0, 7, 20])
def test_fast_levels_one_launch_equals_plain(dev, b, th):
    """Level lists mixing tiny, odd and KITTI-sized levels: one launch,
    every level bit-equal to the plain version."""
    rng = np.random.default_rng(10 * b + th)
    shapes = [(376, 1241), (1, 1), (33, 65), (5, 7), (87, 203)]
    levels = [_u8(rng, b, h, w).to(dev) for h, w in shapes]
    levels[0] = image.gaussian_blur(levels[0], 7, 2.0)
    before = fast_cuda.launches
    got = fast_cuda.fast_score_levels(levels, th)
    assert fast_cuda.launches == before + 1
    assert len(got) == len(levels)
    for lv, g in zip(levels, got):
        ref = fast.fast_score(lv, th)
        torch.cuda.synchronize()
        assert g.dtype == torch.int16 and g.is_contiguous() and torch.equal(g, ref)


def _edge_yx(h, w):
    """Keypoints 0-5 and 18-19 px from every edge and corner of an (h, w)
    canvas: the patch columns outside the canvas are left out, the window
    rows and columns clamped."""
    near = lambda n: (0, 2, 5, 18, 19, n - 20, n - 19, n - 6, n - 3, n - 1)
    return [(r, c) for r in near(h) for c in near(w)]


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 4001])
def test_orient_brief_kernel_equals_plain(dev, n):
    rng = np.random.default_rng(n)
    h, w = 160, 333
    raw = _u8(rng, h, w)
    blur = image.gaussian_blur(raw, 7, 2.0)
    yx = np.stack([rng.integers(19, h - 19, n), rng.integers(19, w - 19, n)], 1)
    edge = np.array(_edge_yx(h, w)[:n], dtype=yx.dtype).reshape(-1, 2)
    yx[:len(edge)] = edge
    yx = torch.from_numpy(yx.astype(np.int32).reshape(n, 2))
    raw, blur, yx = raw.to(dev), blur.to(dev), yx.to(dev)
    ang, desc = finish_cuda.orient_brief(raw, blur, yx)
    ang_p, desc_p = finish_cuda.orient_brief_plain(raw, blur, yx)
    torch.cuda.synchronize()
    assert ang.shape == (yx.shape[0],) and desc.shape == (yx.shape[0], 32)
    assert torch.equal(ang, ang_p)
    assert torch.equal(desc, desc_p)


def _sad_centers(rng, n, H, W):
    """n window centers: the first ones at every residue of xl and xr mod
    16 and at the clip limits (first and last rows and columns), the rest
    random inside the clip."""
    w, l = stereo_cuda._W, stereo_cuda._L
    yc = rng.integers(w, H - w, n)
    xl = rng.integers(w, W - w, n)
    xr = rng.integers(w + l, W - w - l, n)
    lim = [(y, a, b) for y in (w, H - w - 1) for a in (w, W - w - 1)
           for b in (w + l, W - w - l - 1)]
    res = [(w + i, 16 + i, 16 + (i + 5) % 16) for i in range(16)]
    fixed = np.array(lim + res)[:n]
    yc[:len(fixed)], xl[:len(fixed)], xr[:len(fixed)] = fixed.T
    return [v.astype(np.int32) for v in (yc, xl, xr)]


@pytest.mark.parametrize("fill", ["random", "extreme"])
@pytest.mark.parametrize("off", range(16))
@pytest.mark.parametrize("W", [1241, 203])
@pytest.mark.parametrize("n", [0, 1, 3, 70, 4001])
def test_sad_kernel_equals_plain(dev, n, W, off, fill):
    """Canvases as the main path hands them over: [0] and [1] of one
    (2, H, W) tensor, here a view `off` bytes into a buffer that ends where
    the right canvas does, so the words around the first and last window
    rows reach outside both canvases. "extreme" is the top of the range:
    left patches 255 around a center of 0, right windows 0 around 255."""
    rng = np.random.default_rng(1000 * n + W + off)
    H = 96
    yc, xl, xr = _sad_centers(rng, n, H, W)
    c = rng.integers(0, 256, (2, H, W), dtype=np.uint8)
    if fill == "extreme":
        c[0], c[1] = 255, 0
        c[0, yc, xl] = 0
        for d in range(-stereo_cuda._L, stereo_cuda._L + 1):
            c[1, yc, xr + d] = 255
    buf = torch.zeros(off + 2 * H * W, dtype=torch.uint8)
    buf[off:] = torch.from_numpy(c.reshape(-1))
    canvas = buf.to(dev)[off:].view(2, H, W)
    cl, cr = canvas[0], canvas[1]
    centers = [torch.from_numpy(v).to(dev) for v in (yc, xl, xr)]
    before = stereo_cuda.launches
    got = stereo_cuda.sad_windows(cl, cr, *centers)
    assert stereo_cuda.launches == before + (n > 0)
    ref = stereo_cuda.sad_windows_plain(cl, cr, *centers)
    torch.cuda.synchronize()
    assert got.shape == (n, 11) and got.dtype == torch.float32
    assert torch.equal(got, ref)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    img = torch.zeros((40, 60), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        fast_cuda.fast_score(img.to(torch.int16), 7)
    with pytest.raises(ValueError):
        fast_cuda.fast_score(img.t(), 7)
    b2 = torch.zeros((2, 40, 60), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):  # levels with different B
        fast_cuda.fast_score_levels([b2, img[None]], 7)
    with pytest.raises(ValueError):
        fast_cuda.fast_score_levels([b2, b2.to(torch.int16)], 7)
    with pytest.raises(ValueError):
        fast_cuda.fast_score_levels([b2, b2.transpose(1, 2)], 7)
    yx = torch.full((4, 2), 20, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        finish_cuda.orient_brief(img, img, yx.to(torch.int64))
    c = torch.full((4,), 10, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        stereo_cuda.sad_windows(img, img.float(), c, c, c)


def test_device_descent_equals_host_at_orbvoc_scale(dev):
    """The 1M-leaf synthesized tree (k=10, L=6, bench.py's lc1m vocabulary):
    the descent on the card equals the host descent on descriptors near
    its leaves and on random ones, batched and masked."""
    from iv_slam_tpu_torch.slam.vocabulary import Vocabulary

    voc = Vocabulary.synthesize(k=10, L=6, seed=0)
    rng = np.random.default_rng(3)
    near = voc.node_desc[rng.choice(np.nonzero(voc.is_leaf)[0], 1200)]
    near = np.packbits(np.unpackbits(near, axis=1) ^ (rng.uniform(size=(1200, 256)) < 0.08),
                       axis=1)
    descs = np.concatenate([near, rng.integers(0, 256, (400, 32)).astype(np.uint8)])
    host = voc.transform_words(descs)
    np.testing.assert_array_equal(voc.transform_words_device(descs, device=dev), host)
    got = voc.transform_words_device(torch.as_tensor(descs).to(dev).reshape(4, 400, 32))
    np.testing.assert_array_equal(got.reshape(-1), host)
    valid = rng.uniform(size=1600) < 0.5
    np.testing.assert_array_equal(voc.transform_nodes(descs, valid, device=dev),
                                  voc.transform_nodes(descs, valid))


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_ransac_card_equals_cpu(dev, fix_scale):
    """The same sampled indices on the card and on the CPU: the same winning
    hypothesis and inlier set, R, t, s within 1e-5 (Horn's solve runs in
    float64 on both and is rounded once)."""
    from iv_slam_tpu_torch.solvers import sim3_solver

    rng = np.random.default_rng(4)
    n, N = 300, 800
    R, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    R *= np.sign(np.linalg.det(R))
    s, t = 1.0 if fix_scale else 1.2, np.array([0.5, -0.2, 0.3])
    P1 = np.zeros((N, 3), np.float32)
    P1[:n] = np.stack([rng.uniform(-5, 5, n), rng.uniform(-3, 3, n), rng.uniform(4, 20, n)], 1)
    P2 = (s * P1 @ R.T + t).astype(np.float32)
    P2[:60] += rng.uniform(1, 3, (60, 3)).astype(np.float32)
    P2[n:] = 0
    proj = lambda P: np.stack([400 * P[:, 0] / np.maximum(P[:, 2], 1e-9) + 160,  # noqa: E731
                               400 * P[:, 1] / np.maximum(P[:, 2], 1e-9) + 120], 1)
    uv1, uv2 = proj(P1).astype(np.float32), proj(s * P1 @ R.T + t).astype(np.float32)
    valid = np.arange(N) < n
    idx = sim3_solver.sample_sim3(7, 256, n, "cpu")
    out = []
    for d in ("cpu", dev):
        a = [torch.as_tensor(x).to(d) for x in (P1, P2, uv1, uv2, np.ones(N, np.float32), valid)]
        out.append(sim3_solver.sim3_ransac(*a, 400.0, 400.0, 160.0, 120.0, idx.to(d),
                                           fix_scale=fix_scale))
    cpu, card = out
    assert torch.equal(cpu.inliers, card.inliers.cpu()) and int(cpu.n_inliers) >= 200
    for f in ("R", "t", "s"):
        np.testing.assert_allclose(getattr(card, f).cpu().numpy(), getattr(cpu, f).numpy(),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("hw", [(480, 752), (480, 640)], ids=["EuRoC-mono", "TUM-RGB-D"])
def test_single_image_extraction_card_equals_cpu(dev, hw):
    """The monocular and RGB-D frontends' extraction (OrbExtractor on one
    image: K1 once over the 8 levels, K2 once) at the EuRoC and TUM sizes
    with 1000 features: every keypoint field on the card equals the CPU
    path's, and each kernel launches once."""
    from iv_slam_tpu_torch.config import ORBConfig
    from iv_slam_tpu_torch.ops.extractor import OrbExtractor

    rng = np.random.default_rng(hw[1])
    img = image.gaussian_blur(_u8(rng, *hw), 7, 2.0)
    ext = OrbExtractor(ORBConfig(n_features=1000, n_levels=8), *hw)
    cpu = ext(img)
    k1, k2 = fast_cuda.launches, finish_cuda.launches
    card = ext(img.to(dev))
    torch.cuda.synchronize()
    assert (fast_cuda.launches - k1, finish_cuda.launches - k2) == (1, 1)
    for f in cpu._fields:
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
    assert int(cpu.valid.sum()) > 500


def test_initializer_card_equals_cpu(dev):
    """The monocular initializer on the same sampled indices: the same
    model, hypotheses, inliers and is_good set; R, t and the triangulated
    (is_good) points within 1e-4 (float64 throughout on both, rounded
    once: a far point's coordinate may round to the next float32, a few
    ulps below 1e-4 within the parallax check's ~160 baselines; the other
    rows solve degenerate systems and are never used)."""
    from iv_slam_tpu_torch.solvers import initializer

    rng = np.random.default_rng(2)
    n = 400
    X = np.stack([rng.uniform(-5, 5, n), rng.uniform(-3.5, 3.5, n),
                  10.0 + 0.1 * rng.uniform(-5, 5, n)], 1)
    t = np.array([-0.6, 0.05, 0.02])
    proj = lambda P: np.stack([400 * P[:, 0] / P[:, 2] + 160,  # noqa: E731
                               400 * P[:, 1] / P[:, 2] + 120], 1)
    p1 = (proj(X) + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    p2 = (proj(X + t) + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    valid = np.arange(n) < 300
    K = np.array([[400, 0, 160], [0, 400, 120], [0, 0, 1]], np.float32)
    idx = initializer.sample_init(3, valid)
    out = [initializer.initialize_mono(*(torch.as_tensor(a).to(d) for a in (p1, p2, valid, K)),
                                       idx.to(d)) for d in ("cpu", dev)]
    cpu, card = out
    for f in ("ok", "used_homography", "best_h", "best_f", "inliers", "is_good"):
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
    assert bool(cpu.ok)
    good = cpu.is_good.numpy()
    for f in ("R", "t", "points"):
        a, b = getattr(card, f).cpu().numpy(), getattr(cpu, f).numpy()
        if f == "points":   # the rows that did not triangulate are never used
            a, b = a[good], b[good]
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def test_train_step_card_equals_cpu(dev):
    """One train step of the flagship net (64x64, batch 2) on the card and
    on the CPU path from the same weights and batch: the loss within 1e-5
    relative, the parameters within 2e-3 (at a fresh init the gradient
    amplifies float32 rounding: JAX's own jitted and op-by-op steps differ
    by 5.0e-4, tests/test_torch_train.py), the running statistics within
    1e-4 relative."""
    import copy

    from iv_slam_tpu_torch.models import IntrospectionNet, flax_init_
    from iv_slam_tpu_torch.train import train_state as ts

    rng = np.random.default_rng(0)
    batch = dict(image=rng.normal(size=(2, 64, 64, 3)).astype(np.float32),
                 target=rng.uniform(size=(2, 8, 8, 1)).astype(np.float32),
                 mask=(rng.uniform(size=(2, 8, 8, 1)) > 0.2).astype(np.float32))
    net = flax_init_(IntrospectionNet(), torch.Generator().manual_seed(0))
    out = {}
    for d in ("cpu", dev):
        m = copy.deepcopy(net).to(d)
        state = ts.TrainState(m, *ts.make_optimizer(m, max_iters=10))
        loss = float(ts.train_step(state, batch)["loss"])
        out[str(torch.device(d).type)] = loss, {k: v.cpu() for k, v in m.state_dict().items()}
    (l_cpu, cpu), (l_card, card) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(l_card, l_cpu, rtol=1e-5)
    for k, v in cpu.items():
        if k.endswith("num_batches_tracked"):
            assert torch.equal(card[k], v)
        elif k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(card[k], v, rtol=1e-4, atol=1e-5)
        else:
            assert float((card[k] - v).abs().max()) <= 2e-3, k


# ---- the pose LM kernel -------------------------------------------------------

KITTI_K = (718.856, 718.856, 620.5, 188.0, 0.54 * 718.856)


def _lm_problem(seed, n, stereo=0.7, outliers=0.1, qual_lo=1.0, valid=1.0, start=1.0):
    """A pose-LM problem at KITTI's intrinsics: n points 4-40 m ahead of a
    known pose, 0.7 px noise, the given shares of stereo edges, gross
    outliers (20-60 px) and valid edges, quality in [qual_lo, 1], octaves
    0-7, and T0 `start` times a 0.01 rad / 0.1 m draw off the true pose."""
    from iv_slam_tpu_torch.geometry import camera, se3

    rng = np.random.default_rng(seed)
    fx, fy, cx, cy, bf = KITTI_K
    Xc = np.stack([rng.uniform(-20, 20, n), rng.uniform(-3, 3, n), rng.uniform(4, 40, n)], 1)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    T_gt = se3.se3_exp(f32([0.02, -0.01, 0.015, 0.3, -0.1, 0.5])).numpy().astype(np.float64)
    Xw = (Xc - T_gt[:3, 3]) @ T_gt[:3, :3]
    u, v = fx * Xc[:, 0] / Xc[:, 2] + cx, fy * Xc[:, 1] / Xc[:, 2] + cy
    obs = np.stack([u, v, u - bf / Xc[:, 2]], 1) + rng.normal(0, 0.7, (n, 3))
    obs[rng.uniform(size=n) >= stereo, 2] = -1.0
    out = rng.uniform(size=n) < outliers
    obs[out, :2] += rng.uniform(20, 60, (out.sum(), 2)) * rng.choice([-1, 1], (out.sum(), 2))
    dxi = rng.normal(0, 1, 6) * np.array([0.01] * 3 + [0.1] * 3) * start
    return dict(T0=se3.se3_exp(f32(dxi)) @ f32(T_gt), Xw=f32(Xw), obs=f32(obs),
                inv_sigma2=f32(1.0 / 1.2 ** (2 * rng.integers(0, 8, n))),
                qual=f32(rng.uniform(qual_lo, 1.0, n)),
                valid=torch.tensor(rng.uniform(size=n) < valid),
                K=camera.Intrinsics(*(torch.tensor(k, dtype=torch.float32) for k in KITTI_K)))


def _small_far_problem(seed):
    """A 8-29 edge problem with random shares and a start up to 20 times
    the usual draw: such tables end some LM iterations with all ten trials
    rejected."""
    rng = np.random.default_rng(seed + 10 ** 6)
    n, start, outliers = int(rng.integers(8, 30)), rng.uniform(0, 20), rng.uniform(0, 0.5)
    return _lm_problem(seed, n, stereo=rng.uniform(), outliers=outliers, qual_lo=0.1,
                       start=start)


@pytest.fixture(scope="module")
def fused_slice_calls():
    """The inputs of the two pose LMs of test_torch_fused_track.py's slice
    (two tests/synth_world.py frames at 240x320, a map from frame 0, the
    fused step of frame 1), recorded on the CPU path."""
    from synth_world import make_sequence
    from torch_parity import init_map

    from iv_slam_tpu_torch import config
    from iv_slam_tpu_torch.slam import fused_track
    from iv_slam_tpu_torch.slam.device_map import DeviceMap
    from iv_slam_tpu_torch.slam.frame import StereoFrontend
    from iv_slam_tpu_torch.slam.map_store import MapStore
    from iv_slam_tpu_torch.solvers import pose_opt

    world, frames, _ = make_sequence(np.random.default_rng(7), n_frames=2, step=0.08)
    cfg = config.Config()
    cfg.camera = config.CameraConfig(fx=400.0, fy=400.0, cx=160.0, cy=120.0,
                                     bf=float(world.bf), width=world.w, height=world.h)
    cfg.orb = config.ORBConfig(n_features=800, n_levels=4)
    fe = StereoFrontend(cfg, world.h, world.w, device="cpu")
    f0, f1 = fe.process(*frames[0], 0.0), fe.process(*frames[1], 0.1)
    m = MapStore(n_levels=4, scale_factor=cfg.orb.scale_factor)
    init_map(m, f0, cfg.camera)
    dmap = DeviceMap(device="cpu")
    dmap.sync(m)
    tr = fused_track.FusedTracker(cfg, world.h, world.w, device="cpu")
    calls, orig = [], pose_opt.pose_optimization

    def record(*a, **kw):
        calls.append((a, kw))
        return orig(*a, **kw)

    fused_track.pose_opt.pose_optimization = record
    try:
        tr.track(f1, f0, f0.map_pt, f0.pose, dmap)
    finally:
        fused_track.pose_opt.pose_optimization = orig
    assert len(calls) == 2
    return calls


LM_CASES = {
    "n1": lambda: _lm_problem(1, 1),
    "n1024-mixed": lambda: _lm_problem(2, 1024, qual_lo=0.3, valid=0.95),
    "n1536-mixed": lambda: _lm_problem(3, 1536, qual_lo=0.3, valid=0.95),
    "n2047-odd": lambda: _lm_problem(4, 2047, stereo=0.5, qual_lo=0.5),
    "n3001-scratch": lambda: _lm_problem(5, 3001, qual_lo=0.5, valid=0.9),
    "mono-only": lambda: _lm_problem(6, 700, stereo=0.0, qual_lo=0.3),
    "gross-outliers": lambda: _lm_problem(7, 900, outliers=0.4),
    "far-start": lambda: _lm_problem(20, 800, start=4.0, qual_lo=0.3, outliers=0.2),
    "all-masked": lambda: dict(_lm_problem(9, 500), valid=torch.zeros(500, dtype=torch.bool)),
}
# small far-start tables whose first round rejects all ten trials of an
# iteration in the twin on the CPU; the test takes the first that does on the
# card too (where that hangs on the last ulp of a float64 cost sum)
ALL_REJECTED_SEEDS = (61, 271, 272, 274, 280, 330, 343, 352, 378, 390)


def _on(dev, p):
    from iv_slam_tpu_torch.geometry import camera

    K = camera.Intrinsics(*(k.to(dev) for k in p["K"]))
    return tuple(p[k].to(dev) for k in ("T0", "Xw", "obs", "inv_sigma2", "qual", "valid")) + (K,)


def _first_round_trials(args):
    """The twin's trials in each iteration of the first (robust) round."""
    from iv_slam_tpu_torch.solvers import pose_opt

    T0, Xw, obs, inv_s2, qual, valid, K = args
    is_st = obs[:, 2] >= 0
    dsq = torch.where(is_st, 7.815, 5.991) * qual * qual
    return pose_opt._lm_round(T0, Xw, obs, inv_s2, dsq, is_st, valid, K, True, 10)[1].tolist()


@pytest.mark.parametrize("n_rounds", [2, 4])
@pytest.mark.parametrize("case", [*LM_CASES, "all-rejected", "fused-slice-1", "fused-slice-2"])
def test_pose_lm_kernel_equals_plain(dev, request, case, n_rounds):
    """One launch, bit-equal to pose_optimization_plain on the card: the
    pose, inlier flags, chi2 and inlier count."""
    from iv_slam_tpu_torch.solvers import pose_opt, pose_opt_cuda

    if case.startswith("fused-slice"):
        a, _ = request.getfixturevalue("fused_slice_calls")[int(case[-1]) - 1]
        args = _on(dev, dict(zip(("T0", "Xw", "obs", "inv_sigma2", "qual", "valid", "K"), a)))
    elif case == "all-rejected":
        for seed in ALL_REJECTED_SEEDS:
            args = _on(dev, _small_far_problem(seed))
            if max(_first_round_trials(args)) == 10:
                break
        else:
            pytest.fail("no table of ALL_REJECTED_SEEDS rejects ten trials on the card")
    else:
        args = _on(dev, LM_CASES[case]())
    if case == "far-start":
        assert max(_first_round_trials(args)) > 1
    before = pose_opt_cuda.launches
    got = pose_opt.pose_optimization(*args, n_rounds=n_rounds)
    assert pose_opt_cuda.launches == before + 1
    ref = pose_opt.pose_optimization_plain(*args, n_rounds=n_rounds)
    torch.cuda.synchronize()
    for f in ("T", "inlier", "chi2", "n_inliers"):
        g, r = getattr(got, f), getattr(ref, f)
        assert g.dtype == r.dtype and g.shape == r.shape and g.device == r.device, f
        assert torch.equal(g, r), (f, g, r)
    if case == "all-masked":
        assert torch.equal(got.T, args[0]) and int(got.n_inliers) == 0


def test_pose_lm_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from iv_slam_tpu_torch.solvers import pose_opt, pose_opt_cuda

    names = ("T0", "Xw", "obs", "inv_sigma2", "qual", "valid")
    p = _lm_problem(10, 64)
    K_cpu = p["K"]
    *a, K = _on(dev, p)
    p = dict(zip(names, a))

    def call(K=K, n_rounds=4, n_iters=10, **over):
        a = [over.get(k, p[k]) for k in names]
        return pose_opt.pose_optimization(*a, K, n_rounds=n_rounds, n_iters=n_iters)

    before = pose_opt_cuda.launches
    bad = [dict(Xw=p["Xw"].double()), dict(obs=p["obs"][:, :2]), dict(T0=p["T0"][:3]),
           dict(valid=p["valid"].to(torch.uint8)), dict(qual=p["qual"][:-1]),
           dict(inv_sigma2=p["inv_sigma2"].cpu()), dict(K=K_cpu),
           dict(K=K._replace(fx=K.fx.double())), dict(n_iters=0), dict(n_rounds=-1)]
    for over in bad:
        with pytest.raises(ValueError):
            call(**over)
    empty = {k: v[:0] for k, v in p.items() if k != "T0"}
    with pytest.raises(ValueError):
        call(**empty)
    *big, _ = _on(dev, _lm_problem(11, 5462))   # the kernel takes 1 to 5,461 edges
    with pytest.raises(ValueError):
        call(**dict(zip(names, big)))
    assert pose_opt_cuda.launches == before
