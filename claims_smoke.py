#!/usr/bin/env python3
"""The product's claims that chip_smoke.py has no time for, run by the
PyTorch/CUDA port (``iv_slam_tpu_torch``) on one GPU.

Run from the root of a checkout:  python3 claims_smoke.py

chip_smoke.py's claims phase runs the whole cycle and the KITTI all-on
run. This script runs, through the same helper (``tests/torch_claims.py``),
on the card:

  * every IV cycle of tests/test_introspection_helps.py, each the whole
    cycle (vanilla run, datagen, the flagship FCN trained 12 epochs, the
    introspective run on the same pixels), gated as the JAX test gates
    them: the pinned case (ReflectionWorld seed 5; chip_smoke.py ran it
    until its pipeline phase needed the time): OFF ATE above 0.15 m, the
    heatmaps hotter inside the band than 1.5x outside, at least 4 training
    samples, the band response at least 50/255, no more failures ON than
    OFF, ATE ON below 0.90 OFF; the three robustness cases
    (ReflectionWorld seeds 11 and 23, ShimmerWorld seed 5) with the band
    response at least 20/255 and ATE ON below OFF;
  * the C++ oracle of tests/test_parity_ate.py (tools/parity_reference.py's
    protocol: seqA and seqB written by the port, the port's vocabulary
    trained on every 4th seqA frame with K1 and K2 once an image and K3
    never, run_stereo classic and single-threaded) on seqA (chip_smoke.py
    ran it until it outgrew its time limit) and on seqB (seed 23): each ATE
    within 5% of the reference C++ system's, 0.2485 m and 0.2460 m
    (PARITY_ATE.md), no failure, keyframes beside the reference's 6 on
    seqA; then seqA with --fused_tracking (its ATE reported, ungated;
    chip_smoke.py ran it until the drawing phase needed the time);
  * the whole cycle (tests/test_full_cycle.py) and the KITTI all-on run
    (tests/test_kitti_e2e.py) with every gate of their JAX tests, those
    that the JAX package misses too on the same pixels included
    (torch_claims.JAX_MISSES, ROADMAP section C), which chip_smoke.py
    leaves out: while the reference misses them, this script fails;
  * K1-K3 launched once a frame on every run (the wrappers' counters).

It prints the card's name and power limit, one line a run, one
{"claims_smoke": {...}} line (every number, the gates, the rendered
frames' sha1) and, last, {"ok": ..., "device": {...}}. It exits 1 when a
gate fails, 2 without a CUDA device or outside a checkout. It imports
nothing of JAX or of ``iv_slam_tpu``.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
IV_CASES = ("reflection-seed5", "reflection-seed11", "reflection-seed23", "shimmer-seed5")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("claims_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    if not os.path.isfile(os.path.join(HERE, "tests", "torch_claims.py")):
        print("claims_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "tests"))
    sys.path.insert(0, HERE)
    import torch_claims as tc
    from chip_smoke import card_line
    from iv_slam_tpu_torch import _kernels

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"build: {len(_kernels.SOURCES)} sources in {_kernels.build():.2f} s", flush=True)
    work = tempfile.mkdtemp(prefix="claims_smoke_")
    results, failures = {}, []

    def run(name, fn, *args):
        t0 = time.perf_counter()
        try:
            res = fn(*args)
        except Exception as e:  # every run is reported, then the script fails
            traceback.print_exc()
            failures.append(f"{name}: {type(e).__name__}: {e}")
            return None
        res["wall_s"] = time.perf_counter() - t0
        results[name] = res
        bad = tc.failed(res)
        failures.extend(f"{name}: {g} ({json.dumps(res['gates'][g][1], default=float)})"
                        for g in bad)
        print(f"[{name}] {'FAILED ' + str(bad) if bad else 'ok'} ({res['wall_s']:.1f} s)",
              flush=True)
        return res

    for case in IV_CASES:
        res = run(case, tc.iv_case, case, os.path.join(work, case), None)
        if res is not None and "on" in res:
            print(f"{case}: ATE OFF {res['off']['ate_m']:.4f} m -> ON {res['on']['ate_m']:.4f} m"
                  f" (margin {res['margin']}), failures {res['off']['failures']} -> "
                  f"{res['on']['failures']}, heat in/out {res['heat_in']:.2f}/"
                  f"{res['heat_out']:.2f}, band response {res['band_response']:.2f}/255 (gate "
                  f"{res['band_gate']}), {res['dataset']} samples; frames sha1 "
                  f"{res['frames_sha1'][:16]}; on {card}", flush=True)

    def sequences():
        digests = json.loads(tc.write_sequences(work, ["seqA", "seqB"]))
        voc = tc.train_vocab(work, None)
        want = {"fast_score": voc["images"], "orient_brief": voc["images"], "sad_windows": 0}
        return dict(frames_sha1=digests, vocabulary=voc, gates={
            "vocabulary: K1 and K2 once an image, K3 never": [voc["launches"] == want,
                                                               voc["launches"]]})

    def oracle(seq, digests, voc):
        res = tc.oracle(work, seq, None)
        res.update(frames_sha1=digests[seq], vocabulary=voc)
        return res

    run("whole cycle", tc.full_cycle, os.path.join(work, "cycle"), None)
    run("KITTI all on", tc.kitti_all_on, os.path.join(work, "kitti"), None)

    seqs = run("sequences and vocabulary", sequences)
    for seq in ("seqA", "seqB") if seqs is not None else ():
        res = run(f"oracle {seq}", oracle, seq, seqs["frames_sha1"], seqs["vocabulary"])
        if res is None:
            continue
        ref = f" (reference {tc.REF_KEYFRAMES_SEQA})" if seq == "seqA" else ""
        print(f"oracle {seq}: ATE {res['ate_m']:.4f} m (reference C++ {res['reference_ate_m']} "
              f"m, gate {res['gate_m']:.4f} m), {res['failures']} failures, "
              f"{res['keyframes']} keyframes{ref}, {res['frames_per_s']:.3f} frames/s; "
              f"vocabulary {res['vocabulary']['nodes']} nodes from "
              f"{res['vocabulary']['descriptors']} descriptors; frames sha1 "
              f"{res['frames_sha1'][:16]}; on {card}", flush=True)
    if "oracle seqA" in results:
        # seqA with fused tracking (reported, its ATE ungated), beside the
        # classic seqA run
        res = run("oracle seqA fused", tc.oracle, work, "seqA", None, True)
        if res is not None:
            print(f"oracle seqA fused: ATE {res['ate_m']:.4f} m, {res['failures']} failures, "
                  f"{res['keyframes']} keyframes, {res['frames_per_s']:.3f} frames/s; on "
                  f"{card}", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"claims_smoke": dict(results, card=card)}, default=float))
    if failures:
        print("\n".join(["FAILED"] + failures))
    print(json.dumps({"ok": not failures, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
