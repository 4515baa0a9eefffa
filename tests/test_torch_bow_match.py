"""Port: BoW- and Sim3-guided matching (ops/bow_match.py) against the JAX
package's, on the same seeded inputs: the match indices are exact.

search_by_bow: two descriptor sets where b is a shuffled, noisy copy of a
with a rotation of 20 degrees (plus outliers), vocabulary nodes shared by
most true pairs, random validity, and planted ties (duplicate columns, so
the ratio test sees best == second; two a-rows claiming one b-column),
with the orientation check on and off. search_by_sim3: map points seen
from two keyframes related by a Sim3 (scale 1 and 1.15), observed with
1 px noise at random pyramid levels, the second keyframe's features
shuffled. The JAX side runs jitted in a process without FMA contraction
(tests/torch_parity.py), since the window test depends on float32
projections.
"""

import numpy as np
import pytest
import torch

from iv_slam_tpu_torch.ops import bow_match
from torch_parity import BOW_INPUTS, SIM3_INPUTS, one_thread, run_reference  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _noisy(desc, rng, p):
    bits = np.unpackbits(desc, axis=1)
    return np.packbits(bits ^ (rng.uniform(size=bits.shape) < p), axis=1)


def bow_case(seed, n=240, m=260):
    rng = np.random.default_rng(seed)
    desc_a = rng.integers(0, 256, (n, 32)).astype(np.uint8)
    perm = rng.permutation(m)
    src = np.concatenate([np.arange(n), rng.integers(0, n, m - n)])   # b's source rows
    desc_b = _noisy(desc_a[src], rng, 0.04)[perm]
    desc_b[m - 10:] = rng.integers(0, 256, (10, 32))                 # unrelated columns
    desc_b[5] = desc_b[6]                                              # a tie
    node_a = rng.integers(0, 6, n)
    node_b = node_a[src][perm]
    node_b[rng.uniform(size=m) < 0.1] = 7
    angle_a = rng.uniform(0, 360, n).astype(np.float32)
    angle_b = ((angle_a[src] + 20 + rng.normal(0, 3, m)) % 360).astype(np.float32)[perm]
    angle_b[:25] = rng.uniform(0, 360, 25)
    return dict(desc_a=desc_a, node_a=node_a.astype(np.int64),
                angle_a=angle_a, valid_a=rng.uniform(size=n) < 0.9,
                desc_b=desc_b, node_b=node_b.astype(np.int64), angle_b=angle_b,
                valid_b=rng.uniform(size=m) < 0.95,
                nn_ratio=np.float32(0.75 if seed % 2 else 0.7))


def _project(P, f, c):
    return np.stack([f * P[:, 0] / P[:, 2] + c[0], f * P[:, 1] / P[:, 2] + c[1]], 1)


def sim3_case(seed, scale):
    rng = np.random.default_rng(seed)
    n1, n2 = 300, 320
    fx = fy = 400.0
    cx, cy = 160.0, 120.0
    P1 = np.stack([rng.uniform(-6, 6, n1), rng.uniform(-4, 4, n1),
                   rng.uniform(6, 20, n1)], 1).astype(np.float32)
    ang = 0.05
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    t = np.array([0.3, -0.1, 0.2])
    sR12 = (scale * R).astype(np.float32)                              # KF2-cam -> KF1-cam
    P2_all = ((P1 - t) @ R) / scale                                     # S12^-1(P1)
    src = np.concatenate([np.arange(n1), rng.integers(0, n1, n2 - n1)])
    perm = rng.permutation(n2)
    P2 = P2_all[src][perm].astype(np.float32)
    P2[: n2 // 8] += rng.normal(0, 1.0, (n2 // 8, 3)).astype(np.float32)   # bad points
    sf = (1.2 ** np.arange(8)).astype(np.float32)
    oct1 = rng.integers(0, 3, n1).astype(np.int32)
    oct2 = oct1[src][perm]                   # a pair sits on near levels
    oct2 = np.clip(oct2 + rng.integers(-1, 2, n2) * (rng.uniform(size=n2) < 0.3), 0, 7)
    oct2 = oct2.astype(np.int32)
    xy1 = (_project(P1, fx, (cx, cy)) + rng.normal(0, 1.0, (n1, 2))).astype(np.float32)
    xy2 = (_project(P2_all[src][perm], fx, (cx, cy))
           + rng.normal(0, 1.0, (n2, 2))).astype(np.float32)
    desc1 = rng.integers(0, 256, (n1, 32)).astype(np.uint8)
    desc2 = _noisy(desc1[src][perm], rng, 0.06)
    d1 = np.linalg.norm(P1, axis=1)
    d2 = np.linalg.norm(P2, axis=1)
    return dict(P1=P1, desc1=desc1, xy1=xy1, oct1=oct1, valid1=rng.uniform(size=n1) < 0.9,
                P2=P2, desc2=desc2, xy2=xy2, oct2=oct2, valid2=rng.uniform(size=n2) < 0.9,
                sR12=sR12, t12=t.astype(np.float32), fx=np.float32(fx), fy=np.float32(fy),
                cx=np.float32(cx), cy=np.float32(cy), sf=sf,
                log_scale=np.float32(np.log(sf[1] / sf[0])),
                maxd1=(d1 * sf[oct1]).astype(np.float32),
                maxd2=(d2 * sf[oct2]).astype(np.float32))


BOW_SEEDS = (1, 2, 3)
SIM3_CASES = ((4, 1.0), (5, 1.15))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    inputs = {}
    for c, seed in enumerate(BOW_SEEDS):
        inputs.update({f"bow{c}_{k}": v for k, v in bow_case(seed).items()})
    for c, (seed, scale) in enumerate(SIM3_CASES):
        inputs.update({f"sim3{c}_{k}": v for k, v in sim3_case(seed, scale).items()})
    return run_reference("bow_match", tmp_path_factory.mktemp("bow_match"),
                         n_bow=len(BOW_SEEDS), n_sim3=len(SIM3_CASES), **inputs)


@pytest.mark.parametrize("check_orientation", [True, False])
@pytest.mark.parametrize("c", range(len(BOW_SEEDS)))
def test_search_by_bow_matches_jax(reference, c, check_orientation):
    case = bow_case(BOW_SEEDS[c])
    assign, n = bow_match.search_by_bow(*(torch.as_tensor(case[k]) for k in BOW_INPUTS),
                                        check_orientation=check_orientation)
    want = reference[f"bow{c}_{int(check_orientation)}"]
    np.testing.assert_array_equal(assign.numpy(), want)
    assert int(n) == int((want >= 0).sum()) > 60


@pytest.mark.parametrize("c", range(len(SIM3_CASES)))
def test_search_by_sim3_matches_jax(reference, c):
    case = sim3_case(*SIM3_CASES[c])
    args = [torch.as_tensor(case[k]) for k in SIM3_INPUTS]
    assign, n = bow_match.search_by_sim3(*args)
    want = reference[f"sim3{c}"]
    np.testing.assert_array_equal(assign.numpy(), want)
    assert int(n) == int((want >= 0).sum()) > 100
