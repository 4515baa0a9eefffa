"""Port: the vocabulary (slam/vocabulary.py), its device descent (ops/bow.py)
and the keyframe database (slam/keyframe_db.py) against the JAX package's.

Everything here is exact: the trained and synthesized trees (children,
node descriptors, weights, leaves) equal the reference's for the same
seed, since the port draws from the same numpy generator in the same
order; files written by either package load in the other; word ids,
BowVectors (their float64 weights too), FeatureVector nodes, L1 scores and
the database's candidate lists, in order, are equal. The reference runs
its numpy fallbacks here (its C++ host extension is not built), which is
what the port copies. The device descent runs on the CPU.
"""

import numpy as np
import pytest
import torch

from iv_slam_tpu.slam import keyframe_db as jdb
from iv_slam_tpu.slam import vocabulary as jvoc
from iv_slam_tpu_torch.slam import keyframe_db as tdb
from iv_slam_tpu_torch.slam import vocabulary as tvoc
from torch_parity import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

TREE = ("children", "node_desc", "weights", "is_leaf")


@pytest.fixture(scope="module")
def corpus():
    """tests/test_vocabulary.py's corpus: 20 clusters of 50 descriptors with
    3% bit-flip noise."""
    rng = np.random.default_rng(9)
    centers = rng.integers(0, 256, (20, 32)).astype(np.uint8)
    descs = []
    for c in centers:
        bits = np.unpackbits(np.tile(c, (50, 1)), axis=1)
        flip = rng.uniform(size=bits.shape) < 0.03
        descs.append(np.packbits(bits ^ flip, axis=1))
    return np.concatenate(descs)


def assert_same_tree(a, b):
    for f in TREE:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.k, a.L, a.n_words) == (b.k, b.L, b.n_words)


@pytest.mark.parametrize("k,L,seed,n", [(5, 3, 1, 1000), (3, 2, 4, 300), (7, 3, 5, 60),
                                        (10, 6, 0, 1000)])
def test_train_matches_jax(corpus, k, L, seed, n):
    descs = corpus[np.random.default_rng(11).permutation(len(corpus))[:n]]
    assert_same_tree(tvoc.Vocabulary.train(descs, k=k, L=L, seed=seed),
                     jvoc.Vocabulary.train(descs, k=k, L=L, seed=seed))


@pytest.mark.parametrize("k,L,seed", [(4, 4, 0), (10, 3, 2)])
def test_synthesize_matches_jax(k, L, seed):
    assert_same_tree(tvoc.Vocabulary.synthesize(k=k, L=L, seed=seed),
                     jvoc.Vocabulary.synthesize(k=k, L=L, seed=seed))


@pytest.mark.parametrize("fmt", ["npz", "txt"])
def test_files_load_across_packages(corpus, tmp_path, fmt):
    """A vocabulary written by either package loads in the other: the .npz
    layout exactly, the DBoW2 text file with its weights at 6 decimals."""
    tv = tvoc.Vocabulary.train(corpus[:300], k=3, L=2, seed=4)
    jv = jvoc.Vocabulary.train(corpus[:300], k=3, L=2, seed=4)
    p_t, p_j = str(tmp_path / f"t.{fmt}"), str(tmp_path / f"j.{fmt}")
    if fmt == "npz":
        tv.save(p_t)
        jv.save(p_j)
    else:
        tv.save_dbow2_text(p_t)
        jv.save_dbow2_text(p_j)
        with open(p_t) as a, open(p_j) as b:
            assert a.read() == b.read()
    from_j, from_t = tvoc.Vocabulary.load(p_j), jvoc.Vocabulary.load(p_t)
    for got in (from_j, from_t):
        for f in ("children", "node_desc", "is_leaf"):
            np.testing.assert_array_equal(getattr(got, f), getattr(tv, f))
        np.testing.assert_allclose(got.weights, tv.weights, rtol=0,
                                   atol=5e-7 if fmt == "txt" else 0)
    w_t = from_j.word_of_node[from_j.transform_words(corpus[:200])]
    w_j = from_t.word_of_node[from_t.transform_words(corpus[:200])]
    np.testing.assert_array_equal(w_t, w_j)


def _words_products(voc, descs, valid, device):
    nodes = voc.transform_nodes(descs, valid, device=device)
    return (nodes, voc.bow_vector(descs, nodes=nodes), voc.feature_nodes(descs, nodes=nodes),
            voc.feature_vector(descs, nodes=nodes))


@pytest.mark.parametrize("ragged", [False, True])
def test_transform_and_bow_match_jax(corpus, ragged):
    """Host and device descents, BowVector, FeatureVector and L1 scores
    against JAX's; `ragged` trains on 60 descriptors with k=7, so rows of
    the children table are padded with -1 (tests/test_vocabulary.py's
    ragged case)."""
    if ragged:
        small = corpus[np.random.default_rng(11).choice(len(corpus), 60, replace=False)]
        args = (small, 7, 3, 5)
    else:
        args = (corpus, 5, 3, 1)
    tv = tvoc.Vocabulary.train(args[0], k=args[1], L=args[2], seed=args[3])
    jv = jvoc.Vocabulary.train(args[0], k=args[1], L=args[2], seed=args[3])
    if ragged:
        assert (tv.children == -1).any()
    probe = corpus[:300]
    host = jv.transform_words(probe)
    np.testing.assert_array_equal(tv.transform_words(probe), host)
    np.testing.assert_array_equal(tv.transform_words_device(probe, device="cpu"), host)
    np.testing.assert_array_equal(jv.transform_words_device(probe), host)
    batch = probe.reshape(3, 100, 32)
    np.testing.assert_array_equal(
        tv.transform_words_device(torch.as_tensor(batch)).reshape(-1), host)
    valid = np.zeros(300, bool)
    valid[::3] = True
    np.testing.assert_array_equal(tv.transform_words_device(probe, valid=valid, device="cpu"),
                                  jv.transform_words_device(probe, valid=valid))
    for device in (False, "cpu"):
        t = _words_products(tv, probe, valid, device)
        j = _words_products(jv, probe, valid, device is not False)
        np.testing.assert_array_equal(t[0], j[0])
        assert t[1] == j[1]                       # {word: weight}, float64 exact
        np.testing.assert_array_equal(t[2], j[2])
        assert t[3] == j[3]
    a, b = probe[:100], probe[100:220]
    for x, y in ((a, b), (a, a), (b, corpus[500:700])):
        assert tvoc.l1_score(tv.bow_vector(x), tv.bow_vector(y)) == \
            jvoc.l1_score(jv.bow_vector(x), jv.bow_vector(y))


class _CovisMap:
    """covisible_keyframes from a fixed table, for the group funnel."""

    def __init__(self, table):
        self.table = table

    def covisible_keyframes(self, kf_id, min_weight=15):
        return self.table.get(kf_id, [])


def test_keyframe_database_candidates_in_order(corpus):
    """DetectLoopCandidates and DetectRelocalizationCandidates, with a
    covisibility table that groups keyframes, after erasures: the same
    candidates in the same order."""
    tv = tvoc.Vocabulary.train(corpus, k=5, L=3, seed=1)
    jv = jvoc.Vocabulary.train(corpus, k=5, L=3, seed=1)
    rng = np.random.default_rng(5)
    tdb_, jdb_ = tdb.KeyFrameDatabase(tv), jdb.KeyFrameDatabase(jv)
    sets = [corpus[rng.choice(len(corpus), 80, replace=False)] for _ in range(12)]
    for kf, s in enumerate(sets):
        tdb_.add(kf, tv.bow_vector(s))
        jdb_.add(kf, jv.bow_vector(s))
    for db in (tdb_, jdb_):
        db.erase(7)
    table = {k: [((k + d) % 12, 40 - d) for d in (1, 2, 5)] for k in range(12)}
    m = _CovisMap(table)
    for q_kf in (2, 5, 9):
        bits = np.unpackbits(sets[q_kf], axis=1)
        q = np.packbits(bits ^ (rng.uniform(size=bits.shape) < 0.02), axis=1)
        tq, jq = tv.bow_vector(q), jv.bow_vector(q)
        assert tq == jq
        for min_score, connected in ((0.01, set()), (0.05, {q_kf + 1}), (0.3, set())):
            got = tdb_.detect_loop_candidates(99, tq, min_score, connected, m)
            want = jdb_.detect_loop_candidates(99, jq, min_score, connected, m)
            assert got == want
        got = tdb_.detect_relocalization_candidates(tq, m)
        assert got == jdb_.detect_relocalization_candidates(jq, m)
        assert q_kf in got
    tdb_.clear()
    assert tdb_.detect_relocalization_candidates(tv.bow_vector(sets[0]), m) == []


def test_synthesized_tree_descends_on_the_device():
    """A full k^L tree (leaves at depth L only): the device descent equals
    the host one and the reference's."""
    voc = tvoc.Vocabulary.synthesize(k=6, L=5, seed=1)
    rng = np.random.default_rng(2)
    descs = voc.node_desc[rng.choice(len(voc.node_desc), 400)]
    descs = np.packbits(np.unpackbits(descs, axis=1)
                        ^ (rng.uniform(size=(400, 256)) < 0.05), axis=1)
    host = voc.transform_words(descs)
    assert voc.is_leaf[host].all()
    np.testing.assert_array_equal(voc.transform_words_device(descs, device="cpu"), host)
    np.testing.assert_array_equal(host, jvoc.Vocabulary.synthesize(k=6, L=5, seed=1)
                                  .transform_words(descs))
