"""Build and load the hand-written CUDA kernels in ``csrc/``, and the
host C sources beside them.

Each ``csrc/<name>.cu`` exposes a plain C interface (raw pointers, ints and
the CUDA stream; it returns ``cudaGetLastError()``). At first use it is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``iv_slam_tpu_torch/build/`` and loaded with ``ctypes``. Libraries are
named by a hash of their source and flags, so an unchanged source is not
rebuilt within one checkout. No header of PyTorch is included: a file
builds in seconds rather than minutes.

A ``csrc/<name>.c`` is host code (the PNG row unfilter of ``io/png.py``, the
JPEG entropy coder of ``io/jpeg.py``, the vocabulary's parser, Hamming
matrix and tree descent of ``slam/vocabulary.py``):
it is built the same way with the host C compiler (``$CC``, else ``cc``,
``gcc``, ``clang`` or ``g++``) and loaded with ``ctypes``.

A failed build raises. Nothing falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

CC_FLAGS = ["-O2", "-shared", "-fPIC"]

# per-source additions: the pose LM rounds every product and sum on its own,
# as the eager operations of its plain twin do
EXTRA_FLAGS = {"pose_lm": ["-fmad=false"]}

SOURCES = ("fast_score", "orient_brief", "sad_windows", "pose_lm")
HOST_SOURCES = ("png_unfilter", "jpeg_huffman", "vocab_native")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()  # loader threads may ask for one library together
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _cc() -> str:
    for cand in (os.environ.get("CC", ""), "cc", "gcc", "clang", "g++"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    raise RuntimeError("no host C compiler found: set CC or put cc on PATH")


def _source(name: str) -> str:
    return os.path.join(CSRC, name + (".c" if name in HOST_SOURCES else ".cu"))


def _flags(name: str):
    return (CC_FLAGS if name in HOST_SOURCES else NVCC_FLAGS) + EXTRA_FLAGS.get(name, [])


def _lib_path(name: str) -> str:
    with open(_source(name), "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(_flags(name)).encode())
    return os.path.join(BUILD, f"lib{name}_{h.hexdigest()[:12]}.so")


def build(names: Iterable[str] = SOURCES, verbose: bool = False) -> float:
    """Compile the named sources that are not built yet, one compiler
    (``nvcc``, or the host C compiler for a ``.c`` source) per source, all
    started together. Returns the wall seconds it took; raises
    RuntimeError with the compiler's output when any build fails."""
    todo = [n for n in names if n not in _libs and not os.path.exists(_lib_path(n))]
    t0 = time.perf_counter()
    if todo:
        os.makedirs(BUILD, exist_ok=True)
        procs = []
        for n in todo:
            out = _lib_path(n)
            if n in HOST_SOURCES:
                cmd = [_cc(), *_flags(n)]
            else:
                cmd = [_nvcc(), *_flags(n)]
                if verbose:
                    cmd += ["-Xptxas", "-v"]
            # a per-process temporary name: concurrent builders never
            # load a half-written library
            cmd += ["-o", f"{out}.{os.getpid()}.tmp", _source(n)]
            procs.append((n, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for n, out, p in procs:
            log, _ = p.communicate()
            build_log[n] = log
            if p.returncode != 0:
                failed.append(f"--- {os.path.basename(_source(n))} (exit {p.returncode}) "
                              f"---\n{log}")
            else:
                os.replace(f"{out}.{os.getpid()}.tmp", out)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (or ``.c``), built on first
    use."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                build([name])
                lib = _libs[name] = ctypes.CDLL(_lib_path(name))
    return lib


class Launcher:
    """C entry point ``symbol`` of ``csrc/<name>.cu``, typed by ``argtypes``
    (pointers and the stream as ``c_void_p``, ints as ``c_int``). The
    library is built, loaded and the symbol typed at the first call; later
    calls go straight to the typed function. Raises RuntimeError when the
    entry point reports a CUDA error."""

    def __init__(self, name: str, symbol: str, argtypes: list):
        self.name, self.symbol, self.argtypes = name, symbol, argtypes
        self._lib = None
        self._fn = None

    def _resolve(self):
        self._lib = load(self.name)
        fn = getattr(self._lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def __call__(self, *args) -> None:
        err = (self._fn or self._resolve())(*args)
        if err != 0:
            # every source exports ivt_error_string for the message
            msg = self._lib.ivt_error_string
            msg.argtypes = [ctypes.c_int]
            msg.restype = ctypes.c_char_p
            raise RuntimeError(
                f"{self.symbol}: CUDA error {err} ({msg(err).decode()})")


def stream_of(t) -> int:
    """The raw current CUDA stream of tensor ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
