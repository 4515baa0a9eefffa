"""Pack many small host arrays into ONE host-to-device copy.

Port of ``iv_slam_tpu/utils/argpack.py``. A keyframe event's device calls
(triangulation, fuse, local BA) and the tracking step take 3-15 small host
arrays each; uploaded one by one, each is its own pinned staging copy and
its own host-to-device transfer. ``pack_host`` concatenates them into one
flat float32 buffer and returns a hashable spec; ``unpack`` rebuilds each
array on the device from static slices of the uploaded buffer (views, plus
a cast for the integer and boolean ones). float32 carries every dtype the
call sites ship losslessly: bool, uint8, and int32 feature indices and
point ids, all below 2^24; float inputs are float32 already (float64 is
rounded to float32, as the reference's x64-off uploads are).

Usage:
    out = argpack.call_packed(fn, frame_tensor, host_a, host_b)  # 1 copy
    a_dev, b_dev = argpack.upload([host_a, host_b], device)

``call_packed`` copies the buffer from pinned memory with
``non_blocking=True``: the staging block comes from PyTorch's caching host
allocator (``Tensor.pin_memory``), which records the copy's event and does
not hand the block out again before the copy has landed.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

# dtype tags: the dtype each tag unpacks to
_TAGS = {
    "f": torch.float32,
    "i": torch.int32,
    "b": torch.bool,
    "u": torch.uint8,
}


def _tag(dtype: np.dtype) -> str:
    """The transport tag of a dtype.

    Only dtypes that the float32 wire carries LOSSLESSLY are accepted:
    float32 (and float64, rounded to float32), signed ints (magnitude
    checked < 2^24 at pack time, which also makes the int64 -> int32
    narrowing lossless), bool and uint8. Anything else (uint16/32/64,
    float16, complex) would be corrupted silently, so it raises."""
    dt = np.dtype(dtype)
    kind, size = dt.kind, dt.itemsize
    if kind == "f" and size in (4, 8):
        return "f"
    if kind == "i":
        return "i"
    if kind == "b":
        return "b"
    if kind == "u" and size == 1:
        return "u"
    raise TypeError(
        f"argpack: dtype {dt} is not lossless over the float32 wire "
        "(supported: float32/float64, int8/16/32, bool, uint8)")


def pack_host(arrays: Sequence[np.ndarray]) -> Tuple[np.ndarray, tuple]:
    """Concatenate host arrays into one flat float32 buffer.

    Returns (flat, spec), spec a hashable tuple of (shape, dtype tag)."""
    parts = []
    spec = []
    for a in arrays:
        a = np.asarray(a)
        t = _tag(a.dtype)
        if t == "i" and a.size and int(np.abs(a).max()) >= 2 ** 24:
            raise ValueError(
                "argpack: int array with |value| >= 2^24 cannot ride the "
                "float32 wire losslessly (max abs = %d)" % int(np.abs(a).max()))
        spec.append((a.shape, t))
        parts.append(np.ascontiguousarray(a, dtype=np.float32).reshape(-1))
    flat = np.concatenate(parts) if parts else np.zeros(0, np.float32)
    return flat, tuple(spec)


def unpack(flat: torch.Tensor, spec: tuple):
    """The packed arrays as tensors on flat's device: static slices of
    `flat` (float32 ones are views of it), cast for the other tags."""
    out = []
    off = 0
    for shape, tag in spec:
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        x = flat[off:off + n].view(shape)
        if tag != "f":
            x = x.to(_TAGS[tag])
        out.append(x)
        off += n
    return out


def upload(arrays: Sequence[np.ndarray], device) -> list:
    """Host arrays as tensors on `device` through one copy of the packed
    buffer (pinned and non-blocking on CUDA; on the CPU the tensors are
    views of the packed buffer)."""
    flat, spec = pack_host(arrays)
    t = torch.from_numpy(flat)
    device = torch.device(device)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return unpack(t, spec)


def _is_tuple(x) -> bool:
    return isinstance(x, (tuple, list))


def _leaves(args, out):
    for a in args:
        if _is_tuple(a):
            _leaves(a, out)
        else:
            out.append(a)
    return out


def _rebuild(args, it):
    out = []
    for a in args:
        if _is_tuple(a):
            items = _rebuild(a, it)
            # NamedTuples (BAProblem, Intrinsics) keep their type
            out.append(type(a)(*items) if hasattr(a, "_fields")
                       else type(a)(items))
        else:
            out.append(next(it))
    return out


def to_device(args, device):
    """`args` (a tuple or list, nested tuples and NamedTuples allowed) with
    every host numpy leaf replaced by its tensor on `device`, all of them
    from ONE packed copy; tensors and Python scalars pass through."""
    leaves = _leaves(args, [])
    host = [i for i, a in enumerate(leaves) if isinstance(a, np.ndarray)]
    dev = iter(upload([leaves[i] for i in host], device)) if host else iter(())
    hset = set(host)
    new = iter([next(dev) if i in hset else a for i, a in enumerate(leaves)])
    return type(args)(_rebuild(args, new)) if not hasattr(args, "_fields") \
        else type(args)(*_rebuild(args, new))


def call_packed(fn, *args, **kw):
    """``fn(*args, **kw)`` with every host numpy argument (nested in tuples
    and NamedTuples too) shipped as ONE copy to the device of the
    arguments' tensors."""
    leaves = _leaves(args, [])
    device = next((a.device for a in leaves if isinstance(a, torch.Tensor)), None)
    if device is None:
        raise ValueError("argpack.call_packed: no tensor argument names the device")
    return fn(*to_device(args, device), **kw)
