"""Port parity: ops/triangulate.py against the JAX package's, jitted, in the
no-FMA subprocess (tests/torch_parity.py).

* ``triangulate_checked`` on pairs built to take each branch and to fail
  each check: DLT (wide baseline), stereo back-projection from the first
  view and from the second (narrow baseline), no source (narrow, no
  depth), behind the second camera, a reprojection error, a stereo depth
  that is wrong, scale inconsistency, an invalid slot; and pairs whose
  parallax cosine steps across 0.9998, where the DLT gives way to the
  stereo back-projection.
* ``triangulate_event_compact`` at NB = 8 (5 neighbors, 3 padded slots with
  empty free masks), once within T_CAP and once with more epipolar matches
  than T_CAP.

Exact: ``good``, the compacted rows' neighbor and feature columns, their
order and the [accepted, matched] tail. X within 5e-5 relative (the DLT's
eigenvector is float64 here, float32 in the reference; 2.0e-5 seen).
"""

import numpy as np
import pytest
import torch

from iv_slam_tpu_torch.geometry import se3
from iv_slam_tpu_torch.ops import triangulate as tri
from torch_parity import one_thread  # noqa: F401 (fixture)
from torch_parity import TRI_EVENT_INPUTS, TRI_PAIR_INPUTS, run_reference

pytestmark = pytest.mark.usefixtures("one_thread")

FX, FY, CX, CY, BF = 400.0, 400.0, 160.0, 120.0, 200.0   # baseline 0.5 m
SF = (1.2 ** np.arange(8)).astype(np.float32)


def rigid(rng, t, r_sigma=0.01):
    xi = np.concatenate([rng.normal(0, r_sigma, 3), np.zeros(3)])
    T = se3.se3_exp(torch.tensor(xi, dtype=torch.float32)).numpy()
    T[:3, 3] = t
    return T.astype(np.float32)


def project(T, X):
    pc = X @ T[:3, :3].T + T[:3, 3]
    return np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY], 1), pc[:, 2]


def pair_inputs(rng):
    """(inputs, kind per pair): groups of pairs per branch and check."""
    T1 = rigid(rng, [0.1, -0.05, 0.02])
    groups = []

    def group(kind, n, base, depth=(6, 12), stereo=(True, True), oct2=None, edit=None,
              spread=3.0):
        X = np.stack([rng.uniform(-spread, spread, n), rng.uniform(-2, 2, n),
                      rng.uniform(*depth, n)], 1).astype(np.float32)
        X = (X - T1[:3, 3]) @ T1[:3, :3]            # in front of camera 1
        T2 = [rigid(rng, [-b, rng.normal(0, 0.02), rng.normal(0, 0.02)]) for b in base(n)]
        xy1, z1 = project(T1, X)
        xy2, z2 = np.stack([project(T[None][0], X[i:i + 1])[0][0] for i, T in enumerate(T2)]), \
            np.array([project(T, X[i:i + 1])[1][0] for i, T in enumerate(T2)])
        xy1 = xy1 + rng.normal(0, 0.2, xy1.shape)
        xy2 = xy2 + rng.normal(0, 0.2, xy2.shape)
        o1 = rng.integers(0, 3, n)
        o2 = o1 if oct2 is None else oct2(n)
        d = dict(xy1=xy1, xy2=xy2, depth1=np.where(stereo[0], z1, -1.0),
                 depth2=np.where(stereo[1], z2, -1.0), o1=o1, o2=o2, T2=np.stack(T2),
                 valid=np.ones(n, bool))
        d["ur1"] = np.where(d["depth1"] > 0, xy1[:, 0] - BF / z1, -1.0)
        d["ur2"] = np.where(d["depth2"] > 0, xy2[:, 0] - BF / z2, -1.0)
        if edit is not None:
            edit(d)
        groups.append((kind, d))

    wide = lambda n: rng.uniform(1.5, 3.0, n)        # noqa: E731
    narrow = lambda n: rng.uniform(0.01, 0.05, n)    # noqa: E731
    group("dlt", 40, wide)
    group("dlt mono", 30, wide, stereo=(False, False))
    group("stereo 1", 40, narrow, stereo=(True, False))
    group("stereo 2", 40, narrow, stereo=(False, True))
    group("no source", 20, narrow, depth=(20, 30), stereo=(False, False))
    group("behind 2", 20, wide, depth=(6, 12),
          edit=lambda d: d.update(T2=d["T2"] @ np.diag([-1, 1, -1, 1]).astype(np.float32)))
    group("reprojection", 30, wide, edit=lambda d: d["xy1"].__iadd__(
        np.stack([np.zeros(30), rng.choice([-1, 1], 30) * rng.uniform(8, 20, 30)], 1)))
    group("wrong depth", 20, narrow, stereo=(True, False),
          edit=lambda d: d["depth1"].__imul__(1.6))
    group("scale", 20, wide, oct2=lambda n: np.full(n, 7), edit=lambda d: d["o1"].__imul__(0))
    group("invalid", 10, wide, edit=lambda d: d["valid"].__iand__(False))
    # parallax cosines across 0.9998 (~0.02 rad), depth 30-40 m so that the
    # stereo cosine (> 0.9998) leaves the 0.9998 clamp as the threshold
    group("threshold", 60, lambda n: np.linspace(0.5, 0.9, n), depth=(34, 36), spread=0.5,
          stereo=(True, False))

    cat = lambda k: np.concatenate([d[k] for _, d in groups])  # noqa: E731
    kinds = np.concatenate([[kind] * len(d["valid"]) for kind, d in groups])
    o1, o2 = cat("o1"), cat("o2")
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    inputs = dict(xy1=f32(cat("xy1")), xy2=f32(cat("xy2")), ur1=f32(cat("ur1")),
                  depth1=f32(cat("depth1")), ur2=f32(cat("ur2")), depth2=f32(cat("depth2")),
                  sigma2_1=SF[o1] ** 2, sigma2_2=SF[o2] ** 2, scale1=SF[o1], scale2=SF[o2],
                  valid=cat("valid"), T1w=T1, T2w=f32(cat("T2")), fx=np.float32(FX),
                  fy=np.float32(FY), cx=np.float32(CX), cy=np.float32(CY), bf=np.float32(BF))
    return inputs, kinds


def event_inputs(rng, n1, n_true, n_real=5, nb=8):
    """One keyframe and n_real neighbors seeing n_true points (each frame's
    keypoints in its own order, clutter after), padded to nb slots."""
    X = np.stack([rng.uniform(-8, 8, n_true), rng.uniform(-5, 5, n_true),
                  rng.uniform(8, 20, n_true)], 1).astype(np.float32)
    desc = rng.integers(0, 256, (n_true, 32), dtype=np.uint8)
    octv = rng.integers(0, 3, n_true)
    T1 = rigid(rng, [0.0, 0.0, 0.0])

    def frame(T):
        xy, z = project(T, X)
        order = rng.permutation(n_true)
        d = desc[order].copy()
        flips = rng.integers(0, 256, (n_true, 3))
        for j in range(3):
            np.bitwise_xor.at(d, (np.arange(n_true), flips[:, j] // 8),
                              (1 << (flips[:, j] % 8)).astype(np.uint8))
        m = n1 - n_true
        stereo = rng.uniform(size=n_true) < 0.5
        zz = z[order]
        xy_o = xy[order] + rng.normal(0, 0.2, (n_true, 2))
        return dict(
            xy=np.concatenate([xy_o, rng.uniform(0, [320, 240], (m, 2))]).astype(np.float32),
            desc=np.concatenate([d, rng.integers(0, 256, (m, 32), dtype=np.uint8)]),
            free=rng.uniform(size=n1) < 0.95,
            ur=np.concatenate([np.where(stereo, xy_o[:, 0] - BF / zz, -1.0),
                               -np.ones(m)]).astype(np.float32),
            depth=np.concatenate([np.where(stereo, zz, -1.0), -np.ones(m)]).astype(np.float32),
            oct=np.concatenate([octv[order], rng.integers(0, 3, m)]).astype(np.int32))

    f1 = frame(T1)
    K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float64)
    Kinv = np.linalg.inv(K)
    O1 = -T1[:3, :3].T @ T1[:3, 3]
    nbs = []
    for i in range(n_real):
        T2 = rigid(rng, [-1.0 - 0.5 * i, rng.normal(0, 0.1), rng.normal(0, 0.2)])
        f2 = frame(T2)
        R12 = T1[:3, :3] @ T2[:3, :3].T
        t12 = -(R12 @ T2[:3, 3]) + T1[:3, 3]
        tx = np.array([[0, -t12[2], t12[1]], [t12[2], 0, -t12[0]], [-t12[1], t12[0], 0]])
        c = T2[:3, :3] @ O1 + T2[:3, 3]
        f2.update(T2=T2, F12=(Kinv.T @ tx @ R12 @ Kinv).astype(np.float32),
                  ep=np.array([FX * c[0] / c[2] + CX, FY * c[1] / c[2] + CY], np.float32))
        nbs.append(f2)
    rows = nbs + [nbs[0]] * (nb - n_real)
    st = lambda k: np.stack([r[k] for r in rows])  # noqa: E731
    free2 = st("free")
    free2[n_real:] = False                          # padded slots match nothing
    return dict(xy1=f1["xy"], desc1=f1["desc"], free1=f1["free"], ur1=f1["ur"],
                depth1=f1["depth"], oct1=f1["oct"], xy2_nb=st("xy"), desc2_nb=st("desc"),
                free2_nb=free2, ur2_nb=st("ur"), depth2_nb=st("depth"), oct2_nb=st("oct"),
                F12_nb=st("F12"), epipole2_nb=st("ep"), ex_check_nb=np.zeros(nb, bool),
                T1w=T1, T2w_nb=st("T2"), sf=SF, fx=np.float32(FX), fy=np.float32(FY),
                cx=np.float32(CX), cy=np.float32(CY), bf=np.float32(BF))


EVENTS = {"within T_CAP": (5, 256, 230), "T_CAP overflow": (6, 512, 480)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pair, kinds = pair_inputs(np.random.default_rng(3))
    events = [event_inputs(np.random.default_rng(s), n1, nt) for s, n1, nt in EVENTS.values()]
    # the two events have different N1: one subprocess each
    refs = []
    for i, ev in enumerate(events):
        refs.append(run_reference(
            "triangulate", tmp_path_factory.mktemp(f"tri{i}"),
            **{"pair_" + k: v for k, v in pair.items()},
            **{"ev_" + k: v[None] for k, v in ev.items()}))
    return pair, kinds, events, refs


def port_pair(pair):
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in pair.items()}
    return tri.triangulate_checked(*(t[k] for k in TRI_PAIR_INPUTS))


def test_triangulate_checked_matches_jax(runs):
    pair, kinds, _, refs = runs
    X, good = port_pair(pair)
    ref = refs[0]
    np.testing.assert_array_equal(good.numpy(), ref["good"])
    g = ref["good"]
    np.testing.assert_allclose(X.numpy()[g], ref["X"][g], rtol=5e-5, atol=1e-5)
    rate = {k: float(ref["good"][kinds == k].mean()) for k in dict.fromkeys(kinds)}
    for k in ("dlt", "dlt mono", "stereo 1", "stereo 2"):
        assert rate[k] >= 0.9, rate
    for k in ("no source", "behind 2", "invalid", "scale"):
        assert rate[k] == 0.0, rate
    assert rate["reprojection"] <= 0.2 and rate["wrong depth"] <= 0.2, rate


def test_parallax_threshold_branch(runs):
    """Near cos_par = 0.9998 both sides compute the parallax cosine with the
    same float32 operations (products summed left to right, correctly
    rounded roots), so they take the same branch: the stereo back-projection
    from view 1 where the cosine reaches 0.9998, else the DLT. The group's
    baselines rise and its depths vary, so the branches interleave around
    the switch."""
    pair, kinds, _, refs = runs
    sel = kinds == "threshold"
    X, good = port_pair(pair)
    T1 = pair["T1w"].astype(np.float64)
    xy1, d1 = pair["xy1"][sel].astype(np.float64), pair["depth1"][sel].astype(np.float64)
    xc = np.stack([(xy1[:, 0] - CX) * d1 / FX, (xy1[:, 1] - CY) * d1 / FY, d1], 1)
    X_s1 = (xc - T1[:3, 3]) @ T1[:3, :3]
    is_s1 = {side: np.abs(x[sel] - X_s1).max(1) < 1e-3
             for side, x in (("port", X.numpy()), ("jax", refs[0]["X"]))}
    np.testing.assert_array_equal(is_s1["port"], is_s1["jax"])
    # the back-projection at the narrow end, the DLT at the wide end
    assert is_s1["port"][:10].all() and not is_s1["port"][-10:].any()
    assert np.count_nonzero(np.diff(is_s1["port"].astype(int))) >= 1
    assert good.numpy()[sel].all()


@pytest.mark.parametrize("name", list(EVENTS))
def test_triangulate_event_compact_matches_jax(runs, name):
    _, _, events, refs = runs
    i = list(EVENTS).index(name)
    ev = events[i]
    out = tri.triangulate_event_compact(
        *(torch.from_numpy(np.asarray(ev[k])) for k in TRI_EVENT_INPUTS)).numpy()
    ref = refs[i]["events"][0]
    assert out.shape == ref.shape == (tri.T_CAP * 6 + 2,)
    np.testing.assert_array_equal(out[-2:], ref[-2:])
    n_good, n_matched = int(out[-2]), int(out[-1])
    rows, rows_ref = out[:-2].reshape(-1, 6), ref[:-2].reshape(-1, 6)
    np.testing.assert_array_equal(rows[:, :3], rows_ref[:, :3])
    np.testing.assert_allclose(rows[:, 3:], rows_ref[:, 3:], rtol=5e-5, atol=1e-5)
    assert (rows[n_good:] == 0).all()
    nb_i = rows[:n_good, 0].astype(int)
    assert (nb_i < 5).all() and (np.diff(nb_i * 10**4 + rows[:n_good, 1]) > 0).all()
    if name == "T_CAP overflow":
        assert n_matched > tri.T_CAP and n_good > 1000, (n_good, n_matched)
    else:
        assert 500 < n_matched <= tri.T_CAP and n_good > 0.7 * n_matched, (n_good, n_matched)
