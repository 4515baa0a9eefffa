#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's entry in BENCHMARK.json names its
configuration; portbench/workloads/<cell>.json holds its traffic and the
name of its driver (portbench/drivers/<driver>.py); each per-layer metric
is read by portbench/metrics/<metric>.py. The run sets up (timed as
``setup_s``, from process start to the window), measures for ``--seconds``,
checks what the window produced against the plain reference
(portbench/reference/), and prints as its last line of standard output one
JSON object: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the device's busy seconds and the
breakdown. The numbers compared with their limits are the last lines of
standard error and the last key of that object.

Exits 3 without a result when the cell's cards are not there, 4 when this
process, or any client process a driver ran, has loaded JAX or the JAX
package.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402


def _environment(root: str) -> None:
    """Every compile cache at a fixed path inside the checkout (the port's
    own kernels build into iv_slam_tpu_torch/build/), and one thread for
    each host math library, set before any of them loads: a run's
    processes share the host's few cores, and idle pool threads spinning
    beside them make the host-bound cells noisy."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    cache = os.path.join(root, "portbench", ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    os.environ["USE_FLAX"] = "0"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, root=None, device=None) -> int:
    """``root``: the checkout (default: this file's); ``device``: run on it
    without the look for cards (the CPU rehearsals)."""
    args = parse(argv)
    root = root or os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    _environment(root)
    from portbench.lib import result, spec

    here = os.path.join(root, "portbench")
    sp = spec.cell_spec(args.workload, root, here)
    chips = int(sp["cell"]["chips"])
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"portbench: {args.workload} needs {chips} CUDA device(s), found {n}",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
        dev_info = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=chips)
    else:
        device = torch.device(device)
        dev_info = dict(platform=device.type, kind=device.type, count=chips)
    ctx = SimpleNamespace(name=args.workload, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=device, root=root, **sp)
    driver = spec.load_module("drivers", sp["workload"]["driver"], here)
    out = driver.run(ctx)
    setup_s = out["t0_ns"] * 1e-9 - T_START
    line = result.build(sp, out, ctx.trace, setup_s, dev_info)
    found = sorted(set(result.forbidden_modules(sys.modules)) | set(out.get("forbidden", ())))
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for name, v, lim in out["checks"]:
        print(f"check {name} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
