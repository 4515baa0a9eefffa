#!/usr/bin/env python3
"""Time the DBoW2 text parser of the port's vocabulary on an ORBvoc-sized
file: ``Vocabulary.synthesize(10, 6)`` (1,111,111 nodes, the reference's
ORBvoc shape) written by ``save_dbow2_text``, then parsed by the C parser
(``csrc/vocab_native.c``, through ``slam/vocabulary.py::parse_vocab_text``)
and by its plain Python version, each once after one warm-up parse of a
small file, with the arrays compared.

    python3 tools/vocab_parse_time.py [--levels 6] [--out DIR]

Run from the root of a checkout; it needs the host C compiler, not a card.
Prints one JSON line: nodes, file bytes, the seconds of each parser and of
``Vocabulary.load_dbow2_text`` (C parser plus the children table), whether
the arrays are equal, and the host's core count.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--levels", type=int, default=6)
    p.add_argument("--out", default=None, help="a directory for the text file (a temporary "
                                               "one when not given)")
    args = p.parse_args(argv)
    sys.path.insert(0, HERE)
    import numpy as np

    from iv_slam_tpu_torch.slam import vocabulary as V

    work = args.out or tempfile.mkdtemp(prefix="vocab_parse_")
    os.makedirs(work, exist_ok=True)
    try:
        small = os.path.join(work, "small.txt")
        V.Vocabulary.synthesize(10, 2).save_dbow2_text(small)
        V.parse_vocab_text(small)             # built and loaded before the clock
        path = os.path.join(work, f"voc_k10_L{args.levels}.txt")
        t0 = time.perf_counter()
        V.Vocabulary.synthesize(10, args.levels).save_dbow2_text(path)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = V.parse_vocab_text(path)
        c_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = V.parse_vocab_text_plain(path)
        plain_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        V.Vocabulary.load_dbow2_text(path)
        load_s = time.perf_counter() - t0
        size = os.path.getsize(path)
    finally:
        if args.out is None:
            shutil.rmtree(work, ignore_errors=True)
    equal = got[:4] == want[:4] and all(
        a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(got[4:], want[4:]))
    print(json.dumps(dict(k=10, L=args.levels, nodes=len(got[4]), bytes=size,
                          write_s=write_s, c_parse_s=c_s, plain_parse_s=plain_s,
                          load_dbow2_text_s=load_s, equal=equal, cores=os.cpu_count())))
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
