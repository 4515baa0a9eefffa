"""Port: argument packing (utils/argpack.py) against the JAX package's.

* tests/test_argpack.py's cases on the port: every supported dtype round
  trips exactly (int64 lands as int32, bool and uint8 keep their kind), an
  int of magnitude >= 2^24 and a lossy dtype raise;
* the flat buffer and the spec equal iv_slam_tpu.utils.argpack.pack_host's
  for the same arrays, bit for bit;
* ``call_packed`` / ``to_device`` ship every host array of an argument
  tree (tuples, NamedTuples) in one copy and pass tensors and Python
  numbers through: the callee sees the arrays it would see unpacked.
"""

from typing import NamedTuple

import numpy as np
import pytest
import torch

from iv_slam_tpu.utils import argpack as jpack
from iv_slam_tpu_torch.utils import argpack


def _arrays():
    return [
        np.array([[1.5, -2.25], [0.0, 3e7]], np.float32),
        np.array([0, -1, 2 ** 24 - 1, -(2 ** 24 - 1)], np.int32),
        np.array([1, 2, 3], np.int64),  # narrowed losslessly under 2^24
        np.array([True, False, True]),
        np.array([0, 127, 255], np.uint8),
        np.array([[0.1, 2.0]], np.float64),  # rounded to float32
        np.float32(7.5) * np.ones((), np.float32),
    ]


def test_supported_dtypes_roundtrip_exact():
    arrays = _arrays()
    out = argpack.upload(arrays, "cpu")
    for a, b in zip(arrays, out):
        assert tuple(b.shape) == a.shape
        np.testing.assert_array_equal(b.numpy(), a.astype(b.numpy().dtype))
    assert out[1].dtype == torch.int32 and out[2].dtype == torch.int32
    assert out[3].dtype == torch.bool and out[4].dtype == torch.uint8
    assert out[5].dtype == torch.float32
    np.testing.assert_array_equal(out[5].numpy(), arrays[5].astype(np.float32))


def test_pack_matches_reference():
    flat, spec = argpack.pack_host(_arrays())
    jflat, jspec = jpack.pack_host(_arrays())
    assert flat.dtype == jflat.dtype == np.float32
    np.testing.assert_array_equal(flat.view(np.uint32), jflat.view(np.uint32))
    assert spec == jspec
    hash(spec)
    # the unpacked arrays equal the reference's unpack of its buffer
    for b, j in zip(argpack.unpack(torch.from_numpy(flat), spec),
                    jpack.unpack(np.asarray(jflat), jspec)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(j))
        assert b.numpy().dtype == np.asarray(j).dtype


def test_int_magnitude_guard_raises():
    with pytest.raises(ValueError, match="2\\^24"):
        argpack.pack_host([np.array([2 ** 24 + 1], np.int64)])
    # 2^24 itself is the first value with an unrepresentable neighbour
    with pytest.raises(ValueError):
        argpack.pack_host([np.array([-(2 ** 24)], np.int32)])
    argpack.pack_host([np.array([2 ** 24 - 1], np.int32)])


@pytest.mark.parametrize("bad", [np.uint16, np.uint32, np.uint64, np.float16])
def test_lossy_dtypes_rejected(bad):
    with pytest.raises(TypeError, match="lossless"):
        argpack.pack_host([np.zeros(3, bad)])
    with pytest.raises(TypeError, match="lossless"):
        jpack.pack_host([np.zeros(3, bad)])


class _Pair(NamedTuple):
    a: object
    b: object


def test_call_packed_tree():
    rng = np.random.default_rng(0)
    host = [rng.normal(size=(5, 3)).astype(np.float32), rng.integers(0, 9, 5).astype(np.int32),
            rng.uniform(size=4) > 0.5]
    dev = torch.arange(6, dtype=torch.float32)
    seen = {}

    def fn(x, pair, t, scale, k=1):
        seen.update(x=x, pair=pair, t=t, scale=scale, k=k)
        return x.sum()

    argpack.call_packed(fn, host[0], _Pair(host[1], (host[2], dev)), dev, 2.0, k=3)
    assert isinstance(seen["pair"], _Pair) and isinstance(seen["pair"].b, tuple)
    np.testing.assert_array_equal(seen["x"].numpy(), host[0])
    np.testing.assert_array_equal(seen["pair"].a.numpy(), host[1])
    np.testing.assert_array_equal(seen["pair"].b[0].numpy(), host[2])
    assert seen["pair"].b[1] is dev and seen["t"] is dev
    assert seen["scale"] == 2.0 and seen["k"] == 3
    with pytest.raises(ValueError, match="device"):
        argpack.call_packed(fn, host[0], host[1], None, 1.0)
