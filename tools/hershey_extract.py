#!/usr/bin/env python3
"""Recover the strokes of OpenCV's Hershey fonts SIMPLEX and PLAIN from cv2.

OpenCV 4 compiles its Hershey glyph tables into the library; no file of them
exists. (OpenCV 5 draws these font faces from built-in outline fonts
instead, so the tool needs an OpenCV 4: run it where one is installed.)
This tool renders each printable ASCII glyph with ``cv2.putText``
at a large integer scale (every glyph vertex then falls on a whole pixel),
finds the lattice points the strokes light, keeps the lattice segments whose
every pixel is lit, drops those that are covered by longer collinear ones,
and checks the result by drawing it with the port's raster module
(``iv_slam_tpu_torch/io/raster.py``) beside cv2 at the scales and
thicknesses the drawers use. Where a glyph differs, segments are split at
interior lattice points that other strokes end on, until it agrees. The
advance of each glyph and the font's base and cap lines come from
``cv2.getTextSize``.

    python3 tools/hershey_extract.py [--out iv_slam_tpu_torch/io/hershey_glyphs.json]

It needs cv2 (the port does not); it prints, per font, how many glyphs are
pixel-equal to cv2 at each checked scale and thickness.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

S = 16                      # pixels a glyph unit when probing
SPAN = 32                   # lattice units scanned on each side of the origin
CHECKS = ((1.0, 1), (0.7, 2), (0.5, 1), (1.3, 1), (2.0, 2), (0.9, 2), (1.0, 2), (0.4, 1))
FONTS = {0: "FONT_HERSHEY_SIMPLEX", 1: "FONT_HERSHEY_PLAIN"}


def stroke_px(x0, y0, x1, y1):
    """putText's thin stroke between whole-pixel points (Bresenham)."""
    from iv_slam_tpu_torch.io import raster

    _, x, y = raster._bresenham(1 << 12, 1 << 12, *[np.array([v], np.int64)
                                                     for v in (x0, y0, x1, y1)])
    return list(zip(x.tolist(), y.tolist()))


def probe(cv2, font, c, base):
    """Lit pixels of glyph `c` at scale S: (lit set, origin (ox, oy))."""
    size = 2 * SPAN * S + 64 + abs(base) * S
    img = np.zeros((size, size), np.uint8)
    ox, oy = SPAN * S + 32, SPAN * S + 32 + max(base, 0) * S
    cv2.putText(img, c, (ox, oy), font, float(S), 255, 1, cv2.LINE_8)
    lit = img > 0
    return lit, ox, oy - base * S


def segments_of(lit, ox, oy):
    """Lattice segments fully lit, without the collinear sub-segments of
    longer ones. Points in glyph units (u, v)."""
    pts = [(u, v) for u in range(-SPAN, SPAN) for v in range(-SPAN, SPAN)
           if lit[oy + v * S, ox + u * S]]
    cand = []
    for a, b in itertools.combinations(pts, 2):
        px = stroke_px(ox + a[0] * S, oy + a[1] * S, ox + b[0] * S, oy + b[1] * S)
        if all(lit[y, x] for x, y in px):
            cand.append((a, b))

    def on(p, a, b):
        cr = (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0])
        return cr == 0 and min(a[0], b[0]) <= p[0] <= max(a[0], b[0]) \
            and min(a[1], b[1]) <= p[1] <= max(a[1], b[1])

    maximal = [s for s in cand
               if not any(t != s and on(s[0], *t) and on(s[1], *t) for t in cand)]
    covered = {p for s in maximal for p in s}
    for p in pts:                          # a dot: a zero-length stroke
        if not any(on(p, *s) for s in maximal):
            maximal.append((p, p))
            covered.add(p)
    return maximal, pts, on


def render(raster, strokes, advance, base, scale, thickness, shape, org):
    font = {"base_line": base, "cap_line": 0,
            "glyphs": {"x": {"advance": advance, "strokes": strokes}}}
    raster._fonts.cache_clear()
    saved = raster._fonts
    raster._fonts = lambda: {99: font}
    try:
        img = np.zeros(shape + (3,), np.uint8)
        raster.put_text(img, "x", org, 99, scale, (255, 255, 255), thickness)
    finally:
        raster._fonts = saved
    return img[..., 0] > 0


def check(cv2, raster, font, c, strokes, advance, base):
    shape, org = (120, 120), (40, 80)
    ok = {}
    for scale, th in CHECKS:
        ref = np.zeros(shape, np.uint8)
        cv2.putText(ref, c, org, font, scale, 255, th, cv2.LINE_8)
        ok[(scale, th)] = bool(np.array_equal(ref > 0, render(raster, strokes, advance, base,
                                                                scale, th, shape, org)))
    return ok


def split_variants(segs, pts, on):
    """Every way of splitting segments at interior lattice points that
    another segment ends on (ambiguous crossings), fewest splits first."""
    ends = {p for s in segs for p in s}
    options = []
    for i, (a, b) in enumerate(segs):
        inner = sorted(p for p in ends if p not in (a, b) and on(p, a, b))
        if inner:
            options.append((i, inner))
    for k in range(1, len(options) + 1):
        for combo in itertools.combinations(options, k):
            out = [s for j, s in enumerate(segs) if j not in {i for i, _ in combo}]
            for i, inner in combo:
                a, b = segs[i]
                chain = sorted([a, *inner, b], key=lambda p: (p[0] - a[0]) ** 2 + (p[1] - a[1]) ** 2)
                out += list(zip(chain[:-1], chain[1:]))
            yield out


def main():
    import cv2
    from iv_slam_tpu_torch.io import raster

    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(os.path.dirname(HERE), "iv_slam_tpu_torch",
                                                 "io", "hershey_glyphs.json"))
    args = p.parse_args()
    if int(cv2.__version__.split(".")[0]) >= 5:
        raise SystemExit(f"cv2 {cv2.__version__} draws no Hershey strokes: run with OpenCV 4")
    doc = {"source": f"recovered from cv2 {cv2.__version__} by tools/hershey_extract.py",
           "units": "glyph units; u from the glyph's left edge, v down from its origin row",
           "fonts": {}}
    for font, name in FONTS.items():
        (_, height), base = cv2.getTextSize("A", font, 1.0, 0)
        glyphs, exact = {}, 0
        for code in range(32, 127):
            c = chr(code)
            advance = cv2.getTextSize(c, font, 1.0, 0)[0][0]
            lit, ox, oy = probe(cv2, font, c, base)
            segs, pts, on = segments_of(lit, ox, oy)
            best, best_ok = segs, check(cv2, raster, font, c, [list(map(list, s)) for s in segs],
                                        advance, base)
            if not all(best_ok.values()):
                for cand in itertools.islice(split_variants(segs, pts, on), 256):
                    ok = check(cv2, raster, font, c, [list(map(list, s)) for s in cand], advance,
                               base)
                    if sum(ok.values()) > sum(best_ok.values()):
                        best, best_ok = cand, ok
                    if all(ok.values()):
                        break
            exact += all(best_ok.values())
            if not all(best_ok.values()):
                print(f"{name} {c!r}: {len(best)} segments, differs at {[k for k, v in best_ok.items() if not v]}")
            glyphs[c] = {"advance": int(advance),
                         "strokes": sorted([list(a), list(b)] for a, b in best)}
        samples = {}
        for text in ("A", "Ag", "bad: 12.5%", "OK  matches: 1234", "LOST  matches: 0"):
            for scale, th in ((1.0, 1), (0.7, 2), (1.0, 2), (0.5, 1)):
                (w, h), b = cv2.getTextSize(text, font, scale, th)
                samples[f"{text}|{scale}|{th}"] = [w, h, b]
        doc["fonts"][str(font)] = {"name": name, "base_line": int(base),
                                   "cap_line": int(height - base), "glyphs": glyphs,
                                   "pixel_equal_glyphs": exact, "checked": [list(c) for c in CHECKS],
                                   "get_text_size": samples}
        print(f"{name}: {exact} of 95 glyphs pixel-equal to cv2 at every checked "
              f"(scale, thickness) {list(CHECKS)}")
    with open(args.out, "w") as f:
        json.dump(doc, f, separators=(",", ":"), sort_keys=True)
        f.write("\n")
    print("wrote", args.out)


if __name__ == "__main__":
    main()
