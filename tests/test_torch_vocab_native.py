"""Port: the vocabulary's host helpers in C (csrc/vocab_native.c, through
slam/vocabulary.py): parse_vocab_text, hamming_matrix and vocab_transform,
held exactly against their plain NumPy versions and against the JAX
package's iv_slam_tpu.native (its NumPy fallbacks here, where its C++
extension is not built) on a k=10, L=3 vocabulary.

* the DBoW2 text file that save_dbow2_text writes, and one written by hand
  with what Python's line reading and str.split() accept: \\r\\n and \\r
  line ends, blank and short lines (skipped), fields past the 35th
  (ignored), tabs, signs, leading zeros, weights in exponent form: the same
  header and arrays, dtypes included; a field that does not parse raises
  as int() / float() do;
* the Hamming matrix of random descriptors;
* the tree descent of random descriptors and of descriptors that tie
  between children (two children with one descriptor, and descriptors
  equidistant from two children): the first child of equals wins, as in
  the plain version and the reference.
"""

import numpy as np
import pytest

from iv_slam_tpu import native as jnative
from iv_slam_tpu_torch.slam import vocabulary as tvoc


@pytest.fixture(scope="module")
def voc():
    return tvoc.Vocabulary.synthesize(10, 3)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


def test_parse_matches_plain_and_reference(voc, tmp_path):
    path = str(tmp_path / "voc.txt")
    voc.save_dbow2_text(path)
    got = tvoc.parse_vocab_text(path)
    _same(got, tvoc.parse_vocab_text_plain(path))
    _same(got, jnative.parse_vocab_text(path))
    assert len(got[4]) == len(voc.node_desc) == 1111
    # the file holds no root descriptor (DBoW2's format): it loads as zeros
    loaded = tvoc.Vocabulary.load_dbow2_text(path)
    for f in ("children", "is_leaf"):
        np.testing.assert_array_equal(getattr(loaded, f), getattr(voc, f))
    np.testing.assert_array_equal(loaded.node_desc[1:], voc.node_desc[1:])
    # weights as written, with six decimals
    np.testing.assert_array_equal(
        loaded.weights, np.array([float("%.6f" % w) for w in voc.weights], np.float32))


def test_parse_edge_cases(tmp_path):
    rng = np.random.default_rng(4)
    rows = []
    for i in range(1, 13):
        d = rng.integers(0, 256, 32)
        fields = [str((i - 1) // 4), str(int(i > 4))] + [str(v) for v in d] + \
                 [repr(float(rng.uniform(0, 3)))]
        if i == 3:
            fields[0] = "+" + fields[0]
            fields[5] = "00" + fields[5]
            fields[34] = "1.25e-3"
        if i == 5:
            fields += ["extra", "7"]
        sep = "\t" if i % 2 else " "
        rows.append(sep.join(fields))
    text = ("10 3 0 0 junk\r\n" + rows[0] + "\r\n\n" + rows[1] + "\r" + "1 0 5 6\n"
            + "\n".join(rows[2:]) + "\n   \n")
    path = tmp_path / "edge.txt"
    path.write_bytes(text.encode())
    got = tvoc.parse_vocab_text(str(path))
    _same(got, tvoc.parse_vocab_text_plain(str(path)))
    _same(got, jnative.parse_vocab_text(str(path)))
    assert len(got[4]) == 13   # the root and the 12 full lines


@pytest.mark.parametrize("bad", ["x", "1.5", "256", ""])
def test_parse_rejects_bad_fields(tmp_path, bad):
    fields = ["0", "1"] + ["7"] * 32 + ["0.5"]
    if bad:
        fields[3] = bad
    path = tmp_path / "bad.txt"
    path.write_text("10 3 0 0\n" + " ".join(fields) + "\n" + ("" if bad else "1 2 3\n"))
    if not bad:    # a header with too few fields
        path.write_text("10 3\n")
    with pytest.raises((ValueError, OverflowError)):
        tvoc.parse_vocab_text_plain(str(path))
    with pytest.raises(ValueError):
        tvoc.parse_vocab_text(str(path))


def test_hamming_matrix(voc):
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (300, 32)).astype(np.uint8)
    b = np.concatenate([a[:20], rng.integers(0, 256, (77, 32)).astype(np.uint8)])
    got = tvoc.hamming_matrix(a, b)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, tvoc.hamming_matrix_plain(a, b))
    np.testing.assert_array_equal(got, jnative.hamming_matrix(a, b))
    assert (np.diagonal(got[:20, :20]) == 0).all()


def test_transform_with_ties(voc):
    children = voc.children.copy()
    node_desc = voc.node_desc.copy()
    root_kids = children[0]
    # two of the root's children share one descriptor: every descriptor
    # nearest to them ties, and the first of the two must win
    node_desc[root_kids[3]] = node_desc[root_kids[1]]
    rng = np.random.default_rng(6)
    desc = rng.integers(0, 256, (400, 32)).astype(np.uint8)
    near = np.repeat(node_desc[root_kids[1]][None], 60, axis=0)
    bits = np.unpackbits(near, axis=1)
    bits[np.arange(60)[:, None], rng.integers(0, 256, (60, 3))] ^= 1
    # a descriptor equidistant from two other children: one's bits with
    # half of those where the two differ (a pair that differs in an even
    # number of bits) copied from the other
    bits_of = [np.unpackbits(node_desc[c]) for c in root_kids]
    i, j = next((i, j) for i in (0, 2, 4) for j in range(i + 1, 10)
                if j not in (1, 3) and (bits_of[i] != bits_of[j]).sum() % 2 == 0)
    diff = np.nonzero(bits_of[i] != bits_of[j])[0]
    mid = bits_of[i].copy()
    mid[diff[: len(diff) // 2]] = bits_of[j][diff[: len(diff) // 2]]
    desc = np.concatenate([desc, np.packbits(bits, axis=1), np.packbits(mid)[None]])
    d = tvoc.hamming_matrix(desc[-1:], node_desc[root_kids])[0]
    assert d[i] == d[j] == d.min()
    got = tvoc.vocab_transform(children, node_desc, desc)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, tvoc.vocab_transform_plain(children, node_desc, desc))
    np.testing.assert_array_equal(got, jnative.vocab_transform(children, node_desc, desc))

    def leaves_under(r):   # synthesize's BFS layout: level-1 node r's leaves
        return (got >= 111 + (r - 1) * 100) & (got < 111 + r * 100)

    # the tied ones descend under the first of the equals, never the other
    assert leaves_under(root_kids[1])[400:460].all()
    assert not leaves_under(root_kids[3]).any()
    assert leaves_under(root_kids[i])[-1]
