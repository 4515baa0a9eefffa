"""What the drivers share: the seeded FCN for a configuration, the window
clock, the sampling of what the window produced for the checks, and the
processes of a cell whose clients run one a process."""

from __future__ import annotations

import os
import sys
import time
import traceback

import numpy as np
import torch

from ..lib import result
from ..reference import fcn as ref
from ..traffic import seeds, weights

READY_TIMEOUT_S = 900.0


def seeded_fcn(cfg: dict, seed: int, device, calib_rgb=None):
    """(the port's IntrospectionNet in eval mode on `device`, the weights
    dict both sides get). With ``calib_rgb`` ((1, H, W, 3) uint8 on the
    device) the head is centred on the reference's prediction for it."""
    from iv_slam_tpu_torch import models

    arch = cfg["fcn"]
    w = weights.fcn_weights(ref.param_shapes(arch), seed, device)
    if calib_rgb is not None:
        stats = {k: v for k, v in w.items() if ref.is_buffer(k)}
        weights.centre_head(w, ref.predict(arch, w, stats, calib_rgb, tuple(cfg["net_hw"])))
    net = models.IntrospectionNet()
    sd = net.state_dict()
    missing = set(w) - set(sd)
    if missing:
        raise KeyError(f"weights the network does not have: {sorted(missing)[:5]}")
    sd.update(w)
    net.load_state_dict(sd)
    return net.to(device).eval(), w


def split(w: dict):
    """(parameters, BatchNorm statistics) of a weights dict."""
    return ({k: v for k, v in w.items() if not ref.is_buffer(k)},
            {k: v for k, v in w.items() if ref.is_buffer(k)})


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def sample(seed: int, key: int, population: int, k: int) -> np.ndarray:
    """k distinct indices of range(population), drawn from the seed."""
    return np.sort(seeds.rng(seed, key).choice(population, size=min(k, population),
                                               replace=False))


def wait_until(t_ns: int) -> None:
    while True:
        left = t_ns - time.time_ns()
        if left <= 0:
            return
        time.sleep(min(left * 1e-9, 0.05))


class MapGap:
    """Accumulates uint8 cost maps against the reference's: the largest
    difference in grey levels and the share of pixels that differ."""

    def __init__(self):
        self.worst, self.diff_px, self.px = 0, 0, 0

    def add(self, got: torch.Tensor, want: torch.Tensor) -> None:
        d = (got.to(want.device).to(torch.int32) - want.to(torch.int32)).abs()
        self.worst = max(self.worst, int(d.max()))
        self.diff_px += int((d > 0).sum())
        self.px += d.numel()

    @property
    def share(self) -> float:
        return self.diff_px / max(self.px, 1)


# --- clients one a process --------------------------------------------------

def _client(body, k: int, args: tuple, conn) -> None:
    """Client k's process, on a core of its own (the parent keeps the first)
    with one thread for torch: runs ``body(k, *args, conn)`` and sends its
    result, with the JAX modules the process holds once it is done."""
    try:
        torch.set_num_threads(1)
        cpus = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, {cpus[(k + 1) % len(cpus)]})
        out = body(k, *args, conn)
        out["forbidden"] = result.forbidden_modules(sys.modules)
        conn.send(("result", out))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise
    finally:
        conn.close()


def run_clients(body, n: int, args: tuple, seconds: float) -> list:
    """Runs ``body`` in n spawned processes. Each sets up, sends
    ("ready", ns) through ``conn``, receives the window's start (wall-clock
    ns, the same for all) and returns its result after the window; a
    client's error is raised here. Every process has ended on return."""
    import multiprocessing as mp

    mpc = mp.get_context("spawn")
    procs, conns = [], []
    try:
        for k in range(n):
            a, b = mpc.Pipe()
            p = mpc.Process(target=_client, args=(body, k, args, b), daemon=True)
            p.start()
            b.close()
            procs.append(p)
            conns.append(a)
        for c in conns:
            _expect(c, "ready", READY_TIMEOUT_S)
        t0 = time.time_ns() + 200_000_000
        for c in conns:
            c.send(t0)
        return [_expect(c, "result", seconds + READY_TIMEOUT_S) for c in conns]
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join()


def _expect(conn, what: str, timeout: float):
    """The next message of a client, which must be `what`."""
    if not conn.poll(timeout):
        raise TimeoutError(f"a client sent no {what} within {timeout:.0f} s")
    kind, payload = conn.recv()
    if kind == "error":
        raise RuntimeError(f"a client failed:\n{payload}")
    if kind != what:
        raise RuntimeError(f"a client sent {kind}, expected {what}")
    return payload


def forbidden(res: list) -> list:
    """The JAX modules any client held once it was done."""
    return sorted({m for r in res for m in r.get("forbidden", ())})
