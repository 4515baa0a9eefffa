"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them. The
main-path shapes are checked by chip_smoke.py; these cases cover the edges
it does not reach: tiny and odd image sizes and level lists mixing them,
keypoint counts that do not fill a block, keypoints 0-5 and 18-19 px
from the canvas edges, clip-limit window centers, and the wrappers'
refusals. This file imports no JAX, so it runs where JAX is not installed:

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


@pytest.mark.parametrize("n", [1, 3, 70])
def test_sad_kernel_equals_plain(dev, n):
    rng = np.random.default_rng(n)
    H, W, w, l = 96, 200, stereo_cuda._W, stereo_cuda._L
    cl, cr = _u8(rng, H, W), _u8(rng, H, W)
    yc = np.r_[rng.integers(w, H - w - 1, n), [w, H - w - 1, w, H - w - 1]]
    xl = np.r_[rng.integers(w, W - w - 1, n), [w, W - w - 1, W - w - 1, w]]
    xr = np.r_[rng.integers(w + l, W - w - l - 1, n),
               [w + l, W - w - l - 1, w + l, W - w - l - 1]]
    args = [cl.to(dev), cr.to(dev)] + [
        torch.from_numpy(v.astype(np.int32)).to(dev) for v in (yc, xl, xr)]
    got = stereo_cuda.sad_windows(*args)
    ref = stereo_cuda.sad_windows_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == (n + 4, 11) and torch.equal(got, ref)


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
