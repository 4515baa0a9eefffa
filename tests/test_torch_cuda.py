"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them. The
main-path shapes are checked by chip_smoke.py; these cases cover the edges
it does not reach: tiny and odd image sizes and level lists mixing them,
keypoint counts that do not fill a block, keypoints 0-5 and 18-19 px
from the canvas edges, clip-limit window centers, SAD canvases that are
views at every byte offset mod 16, and the wrappers' refusals. Beyond the
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
