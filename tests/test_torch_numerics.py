"""The port's device-independent float32 arithmetic (iv_slam_tpu_torch/numerics.py).

Each function must give the float32 result that a plain statement of its
rounding gives in numpy: the correctly rounded value for one operation, a
fixed left-to-right order for small matrix products; ``log`` gives
XLA:CPU's float32 jnp.log bit for bit (run without FMA contraction in
tests/torch_parity.py), which the reference's predicted pyramid levels
rest on. Those are the results the GPU gives too, so the tracking step
makes the same choices on both devices (chip_smoke.py compares a step of
the card with the CPU path).
"""

import numpy as np
import pytest
import torch

from iv_slam_tpu_torch import numerics
from torch_parity import run_reference


def f32(rng, lo, hi, n=1 << 16):
    return rng.uniform(lo, hi, n).astype(np.float32)


@pytest.mark.parametrize("name", ["sqrt", "sin", "cos", "log"])
def test_unary_functions_round_once(rng, name, tmp_path):
    x = f32(rng, 1e-3, 1e4)
    if name == "log":
        # ratios of scale factors: the reference's predicted-level inputs
        x = np.concatenate([x, np.float32(1.2) ** np.arange(8, dtype=np.float32),
                            [1.44], np.exp(rng.uniform(-80, 80, 4096)),
                            [0.0, np.inf, 1e-40]]).astype(np.float32)
        want = run_reference("log", tmp_path, x=x)["log"]
    else:
        want = getattr(np, name)(x.astype(np.float64)).astype(np.float32)
    got = getattr(numerics, name)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_sqrt_is_the_rounded_root(rng):
    x = f32(rng, 0, 1e4)
    np.testing.assert_array_equal(numerics.sqrt(torch.from_numpy(x)).numpy(), np.sqrt(x))


def test_atan2_and_division_by_a_constant(rng):
    y, x = f32(rng, -5, 5), f32(rng, -5, 5)
    np.testing.assert_array_equal(
        numerics.atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy(),
        np.arctan2(y.astype(np.float64), x.astype(np.float64)).astype(np.float32))
    for c in (6.0, 24.0, 120.0, 720.0, 12.0):
        np.testing.assert_array_equal(numerics.div(torch.from_numpy(x), c).numpy(),
                                      x / np.float32(c))


def test_total_is_the_float64_sum_rounded(rng):
    x = f32(rng, -3, 3, 10 * 1537).reshape(10, 1537)
    got = numerics.total(torch.from_numpy(x), dim=-1)
    np.testing.assert_array_equal(got.numpy(), x.astype(np.float64).sum(-1).astype(np.float32))


@pytest.mark.parametrize("shapes", [((5, 3), (3, 3)), ((7, 4, 4), (4, 4)),
                                    ((4, 4), (9, 4, 4)), ((6, 3, 3), (6, 3, 1))])
def test_matmul_sums_left_to_right(rng, shapes):
    a = rng.normal(size=shapes[0]).astype(np.float32)
    b = rng.normal(size=shapes[1]).astype(np.float32)
    got = numerics.matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = a[..., :, 0, None] * b[..., None, 0, :]
    for k in range(1, a.shape[-1]):
        want = want + a[..., :, k, None] * b[..., None, k, :]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 7, 1536, 4608])
def test_tree_sum_is_a_fixed_pairwise_tree(rng, n):
    x = rng.normal(size=(n, 5)).astype(np.float32)
    want = x
    p = 1 << max(n - 1, 0).bit_length()
    want = np.concatenate([want, np.zeros((p - n, 5), np.float32)])
    while want.shape[0] > 1:
        h = want.shape[0] // 2
        want = want[:h] + want[h:]
    got = numerics.tree_sum(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (5,)
    np.testing.assert_array_equal(got.numpy(), want[0])


# ---- the roundings of introspection-weighted extraction -------------------

@pytest.fixture(scope="module")
def iv_reference(tmp_path_factory):
    """jitted JAX (no FMA) on a 376x1241 random cost map and a smooth one,
    and on 200 draws of each cell count at KITTI-00 geometry."""
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[:376, :1241]
    smooth = 127.5 + 127.5 * np.sin(xx / 50.0) * np.cos(yy / 30.0)
    quals = np.stack([rng.integers(0, 256, (376, 1241)), smooth.astype(np.uint8)])
    quals = quals.astype(np.float32)
    sums = {f"sum_{n}": rng.uniform(0, 1, (200, n)).astype(np.float32)
            for n in (12, 27, 52, 80)}
    ref = run_reference("iv_numerics", tmp_path_factory.mktemp("ivnum"), quals=quals, **sums)
    return quals, sums, ref


@pytest.mark.parametrize("den", [255, 256])
def test_quality_table_matches_jax(iv_reference, den):
    np.testing.assert_array_equal(numerics.quality_table(float(den)).numpy(),
                                  iv_reference[2][f"qual{den}"])


def test_xla_cumsum_matches_jnp_cumsum(iv_reference):
    """The level-0 summed-area table of a cost map passes 2^24: a
    left-to-right or a pairwise scan gives other values there."""
    quals, _, ref = iv_reference
    got = numerics.xla_cumsum(numerics.xla_cumsum(torch.from_numpy(quals), 1), 2).numpy()
    assert (ref["cumsum"] > 2 ** 24).any()
    np.testing.assert_array_equal(got, ref["cumsum"])
    seq = np.cumsum(np.cumsum(quals, 1, dtype=np.float32), 2, dtype=np.float32)
    assert (seq != ref["cumsum"]).mean() > 0.1


@pytest.mark.parametrize("n", [12, 27, 52, 80])
def test_xla_sum_matches_jnp_sum(iv_reference, n):
    _, sums, ref = iv_reference
    x = sums[f"sum_{n}"]
    np.testing.assert_array_equal(numerics.xla_sum(torch.from_numpy(x)).numpy(),
                                  ref[f"sum_{n}"])
