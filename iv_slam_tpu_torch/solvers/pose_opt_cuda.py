"""Wrapper of kernel 4, ``csrc/pose_lm.cu``: the motion-only pose LM in one
launch.

``solvers/pose_opt.py::pose_optimization`` sends CUDA tensors here and CPU
tensors to its plain twin, ``pose_optimization_plain``, to which the kernel
is bit-equal on the card. The kernel reads the intrinsics through device
pointers (each ``Intrinsics`` field is a 0-d tensor), so a call reads
nothing back and never waits for the device. The wrapper raises on a wrong
device, dtype or shape, on a table the kernel does not take (1 to 5,461
edges), on ``n_iters < 1`` (the twin's loop needs one iteration), and on a
failed build or launch. ``launches`` counts launches.

Up to 2,048 edges the kernel keeps its rows in shared memory; beyond, in a
scratch buffer allocated here, of the size the kernel's library gives
(``pose_lm_scratch_floats``).
"""

from __future__ import annotations

from ctypes import c_int, c_longlong, c_void_p

import torch

from .. import _kernels

launches = 0
_launch = _kernels.Launcher(
    "pose_lm", "pose_lm_launch",
    [c_void_p] * 11 + [c_int] * 3 + [c_void_p] * 5 + [c_longlong, c_void_p])
_scratch_fn = None


def scratch_floats(n: int) -> int:
    """The kernel's ``pose_lm_scratch_floats``: floats of scratch for a table
    of n edges, 0 while its rows fit in shared memory, -1 for a table the
    kernel does not take."""
    global _scratch_fn
    if _scratch_fn is None:
        fn = _kernels.load("pose_lm").pose_lm_scratch_floats
        fn.argtypes, fn.restype = [c_int], c_longlong
        _scratch_fn = fn
    return _scratch_fn(n)


def pose_lm(T0, Xw, obs, inv_sigma2, qual, valid, K, n_rounds: int, n_iters: int):
    """One launch of the pose LM. Returns (T (4, 4), inlier (N,) bool,
    chi2 (N,) float32, n_inliers () int32), as ``pose_optimization_plain``."""
    global launches
    dev = T0.device
    if dev.type != "cuda":
        raise ValueError(f"pose_lm: needs CUDA tensors, got {dev}")
    n = Xw.shape[0]
    for name, t, dt, shape in (("T0", T0, torch.float32, (4, 4)),
                               ("Xw", Xw, torch.float32, (n, 3)),
                               ("obs", obs, torch.float32, (n, 3)),
                               ("inv_sigma2", inv_sigma2, torch.float32, (n,)),
                               ("qual", qual, torch.float32, (n,)),
                               ("valid", valid, torch.bool, (n,)),
                               *((f"K.{f}", v, torch.float32, ())
                                 for f, v in zip(K._fields, K))):
        if t.dtype != dt or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(
                f"pose_lm: {name} must be a {dt} tensor of shape {shape} on {dev}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if n_rounds < 0 or n_iters < 1:
        raise ValueError(f"pose_lm: n_rounds {n_rounds} (>= 0), n_iters {n_iters} (>= 1)")
    n_scratch = scratch_floats(n)
    if n_scratch < 0:
        raise ValueError(f"pose_lm: the kernel takes 1 to 5,461 edges, not {n}")
    T0, Xw, obs, inv_sigma2, qual, valid = (
        t.contiguous() for t in (T0, Xw, obs, inv_sigma2, qual, valid))
    T = torch.empty((4, 4), dtype=torch.float32, device=dev)
    inlier = torch.empty(n, dtype=torch.bool, device=dev)
    chi2 = torch.empty(n, dtype=torch.float32, device=dev)
    n_in = torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev) if n_scratch else None
    with torch.cuda.device(dev):
        _launch(T0.data_ptr(), Xw.data_ptr(), obs.data_ptr(), inv_sigma2.data_ptr(),
                qual.data_ptr(), valid.data_ptr(), *(v.data_ptr() for v in K),
                n, n_rounds, n_iters, T.data_ptr(), inlier.data_ptr(), chi2.data_ptr(),
                n_in.data_ptr(), scratch.data_ptr() if scratch is not None else None,
                n_scratch, _kernels.stream_of(T0))
    launches += 1
    return T, inlier, chi2, n_in
