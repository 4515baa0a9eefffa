#!/usr/bin/env python3
"""Probes of kernel 3 (``iv_slam_tpu_torch/csrc/sad_windows.cu``) on one GPU:
how much of its time is the launch itself, and how much of the design
before it was its row loop's rounds of load latency.

    python3 tools/sad_probes.py --parent DIR [--rounds 2]

DIR is a checkout of an earlier tree (``git archive <commit> | tar -x -C
DIR``) whose ``sad_windows.cu`` has the one-warp-a-keypoint row loop. The
probes are built with nvcc into the gitignored ``tmp/sad_probes/``, never
into the package:

  * ``parent``: DIR's ``sad_windows.cu`` as it is;
  * ``unroll``: the same with ``#pragma unroll`` on its row loop, so that
    all its loads can start before the first is used;
  * ``empty``, ``empty_parent``: a kernel that does nothing, launched with
    this tree's grid (16 keypoints and 176 threads a block) and with the
    parent's (4 keypoints and 128 threads a block): a launch's own device
    time, the least any form of the kernel can take.

Each is timed beside this tree's kernel (``current``) at the inputs one
KITTI-sized frame hands the wrapper (recorded as ``chip_smoke.py`` records
them), by torch.profiler device time, in turns, ``--rounds`` times, the
order reversed every other round. ``parent`` and ``unroll`` are first held
bit-equal to the plain version. Prints the card and one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tmp", "sad_probes")

EMPTY = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int sad_windows_launch(const void*, const void*, int, int, const void*,
                                  const void*, const void*, int N, void*, void* stream) {
  if (N <= 0) return 0;
  empty_kernel<<<(N + KP - 1) / KP, THREADS, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""
ROW_LOOP = "  for (int r = -HW; r <= HW; ++r) {"


def sources(parent_dir):
    with open(os.path.join(parent_dir, "iv_slam_tpu_torch", "csrc", "sad_windows.cu")) as f:
        parent = f.read()
    if parent.count(ROW_LOOP) != 1:
        raise SystemExit(f"{parent_dir}: sad_windows.cu has no single row loop {ROW_LOOP!r}")
    return {
        "parent": (parent, []),
        "unroll": (parent.replace(ROW_LOOP, "#pragma unroll\n" + ROW_LOOP), []),
        "empty": (EMPTY, ["-DKP=16", "-DTHREADS=176"]),
        "empty_parent": (EMPTY, ["-DKP=4", "-DTHREADS=128"]),
    }


def build(srcs, nvcc, flags):
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, (text, defs) in srcs.items():
        cu = os.path.join(OUT, name + ".cu")
        with open(cu, "w") as f:
            f.write(text)
        cmd = [nvcc, *flags, *defs, "-o", os.path.join(OUT, f"lib{name}.so"), cu]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
    return {name: os.path.join(OUT, f"lib{name}.so") for name in srcs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="checkout of the earlier tree")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("sad_probes: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from types import SimpleNamespace

    from iv_slam_tpu_torch import _kernels, config
    from iv_slam_tpu_torch.ops import fast_cuda, finish_cuda, stereo_cuda
    from iv_slam_tpu_torch.slam import frame

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    libs = build(sources(args.parent), _kernels._nvcc(), _kernels.NVCC_FLAGS)

    cfg = config.Config()
    cfg.camera = config.CameraConfig(width=cs.W, height=cs.H)
    cfg.orb = config.ORBConfig(n_features=2000, n_levels=8, ini_th_fast=20, min_th_fast=7)
    fe = frame.StereoFrontend(cfg, cs.H, cs.W)
    ops = SimpleNamespace(fast_cuda=fast_cuda, finish_cuda=finish_cuda, stereo_cuda=stereo_cuda)
    smoke = cs.Smoke(torch, {"ops": ops})
    rec = smoke.record_inputs(fe, *cs.test_pair(cs.H, cs.W))
    canvas, _, yc, xl, xr = rec["sad_windows"][0]
    cl, cr = canvas[0], canvas[1]
    n = yc.shape[0]
    argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]

    def caller(path):
        fn = ctypes.CDLL(path).sad_windows_launch
        fn.argtypes, fn.restype = argtypes, ctypes.c_int

        def run():
            out = torch.empty((n, 11), dtype=torch.float32, device=cl.device)
            err = fn(cl.data_ptr(), cr.data_ptr(), cl.shape[0], cl.shape[1], yc.data_ptr(),
                     xl.data_ptr(), xr.data_ptr(), n, out.data_ptr(),
                     _kernels.stream_of(cl))
            cs.require(err == 0, f"{path}: CUDA error {err}")
            return out
        return run

    fns = {name: caller(path) for name, path in libs.items()}
    fns["current"] = lambda: stereo_cuda.sad_windows(cl, cr, yc, xl, xr)
    plain = stereo_cuda.sad_windows_plain(cl, cr, yc, xl, xr)
    for name in ("parent", "unroll", "current"):
        got = fns[name]()
        torch.cuda.synchronize()
        cs.require(torch.equal(got, plain), f"{name} != plain")
    print(f"parent, unroll and current bit-equal to the plain version at {n} keypoints, "
          f"canvas {tuple(canvas.shape)}", flush=True)

    order = ["parent", "unroll", "current", "empty", "empty_parent"]
    ms = {name: [] for name in order}
    for i in range(args.rounds):
        for name in (order if i % 2 == 0 else order[::-1]):
            ms[name].append(cs.device_ms(torch, fns[name], iters=200, warmup=10))
    for name in order:
        print(f"{name:13s} device ms/launch: {ms[name]}")
    print(json.dumps({"sad_probes_ms": ms, "keypoints": n, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
