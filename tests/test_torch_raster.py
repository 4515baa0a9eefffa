"""The port's raster module (iv_slam_tpu_torch/io/raster.py) against cv2.

Exact, pixel for pixel, against the installed cv2 (OpenCV 5.0 here; the same
script run against OpenCV 4.13 on the card's machine also gave 0
differences): COLORMAP_JET on all 256 values, addWeighted on all 256 x 256
pairs at 0.5/0.5, and every primitive the drawing modules use on noisy
images with end points inside and outside the image: line at thickness 1-3
(LINE_8) and 1-2 (LINE_AA), circle filled and at thickness 1 and 2,
rectangle, arrowedLine at thickness 1 and 2; and many primitives of mixed
kinds painted in one Batch equal the same cv2 calls made one after the
other (the last drawn wins a pixel).

Text (C6 in ROADMAP): OpenCV 5 draws FONT_HERSHEY_* with outline fonts, so
the Hershey strokes were recovered from OpenCV 4.13 by
tools/hershey_extract.py, which checked every printable glyph of both fonts
pixel-equal to it at 8 scale/thickness pairs and recorded its getTextSize
for sample strings. Here: the table records 95 of 95 glyphs equal for each
font, get_text_size equals every recorded cv2 4.13 result, and put_text
draws nothing outside the strokes' box (their extent, widened by the
thickness).
"""

import json
import os
import string

import cv2
import numpy as np
import pytest

from iv_slam_tpu_torch.io import raster as R
from torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

H, W = 60, 80


def test_jet_lut_all_values():
    v = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(R.apply_colormap_jet(v), cv2.applyColorMap(v, cv2.COLORMAP_JET))


def test_add_weighted_all_pairs():
    a = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 256, 1)
    b = a.T.copy()
    np.testing.assert_array_equal(R.add_weighted(a, 0.5, b, 0.5, 0.0),
                                  cv2.addWeighted(a, 0.5, b, 0.5, 0.0))
    c3, d3 = (np.random.default_rng(1).integers(0, 256, (32, 32, 3), dtype=np.uint8)
              for _ in range(2))
    np.testing.assert_array_equal(R.add_weighted(c3, 0.3, d3, 0.8, 7.0),
                                  cv2.addWeighted(c3, 0.3, d3, 0.8, 7.0))


def test_gray2bgr():
    g = np.random.default_rng(2).integers(0, 256, (7, 9), dtype=np.uint8)
    np.testing.assert_array_equal(R.gray2bgr(g), cv2.cvtColor(g, cv2.COLOR_GRAY2BGR))


def _pts(rng, k, lo=-20, hi=100):
    return [int(v) for v in rng.integers(lo, hi, k)]


def _line(th, aa):
    lt = cv2.LINE_AA if aa else cv2.LINE_8

    def draw(lib, img, rng):
        x0, y0, x1, y1 = _pts(rng, 4)
        col = tuple(int(c) for c in rng.integers(0, 256, 3))
        if lib == "cv2":
            cv2.line(img, (x0, y0), (x1, y1), col, th, lt)
        else:
            R.line(img, (x0, y0), (x1, y1), col, th, R.LINE_AA if aa else R.LINE_8)
    return draw


def _circle(th):
    def draw(lib, img, rng):
        x, y, r = _pts(rng, 3)
        r = abs(r) % 20
        (cv2.circle if lib == "cv2" else R.circle)(img, (x, y), r, (9, 8, 7), th)
    return draw


def _rect(th):
    def draw(lib, img, rng):
        x0, y0, x1, y1 = _pts(rng, 4)
        (cv2.rectangle if lib == "cv2" else R.rectangle)(img, (x0, y0), (x1, y1), (5, 6, 7), th)
    return draw


def _arrow(th):
    def draw(lib, img, rng):
        x0, y0, x1, y1 = _pts(rng, 4, 0, 80)
        if lib == "cv2":
            cv2.arrowedLine(img, (x0, y0), (x1, y1), (5, 6, 7), th, cv2.LINE_8, 0, 0.1)
        else:
            R.arrowed_line(img, (x0, y0), (x1, y1), (5, 6, 7), th)
    return draw


PRIMITIVES = {
    "line1": _line(1, False), "line2": _line(2, False), "line3": _line(3, False),
    "line_aa1": _line(1, True), "line_aa2": _line(2, True),
    "circle_filled": _circle(-1), "circle1": _circle(1), "circle2": _circle(2),
    "rect1": _rect(1), "rect_filled": _rect(-1), "arrow1": _arrow(1), "arrow2": _arrow(2),
}


@pytest.mark.parametrize("name", sorted(PRIMITIVES))
def test_primitive_pixel_equal_to_cv2(name):
    draw = PRIMITIVES[name]
    bad = []
    for t in range(150):
        seed = 1000 * sorted(PRIMITIVES).index(name) + t
        a = np.random.default_rng(seed).integers(0, 256, (H, W, 3), dtype=np.uint8)
        b = a.copy()
        draw("cv2", a, np.random.default_rng(seed + 7))
        draw("port", b, np.random.default_rng(seed + 7))
        if not np.array_equal(a, b):
            bad.append(t)
    assert not bad, f"{name}: {len(bad)} of 150 differ, first {bad[:5]}"


def test_batch_keeps_painters_order():
    """Overlapping circles, squares and lines of many colours in one Batch
    (keys in the call order of the cv2 calls) equal cv2's calls one after
    the other."""
    rng = np.random.default_rng(4)
    ref = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    img = ref.copy()
    b = R.Batch(img.shape)
    for k in range(300):
        kind = k % 3
        x, y = (int(v) for v in rng.integers(-5, 85, 2))
        col = tuple(int(c) for c in rng.integers(0, 256, 3))
        if kind == 0:
            cv2.circle(ref, (x, y), 2, col, -1)
            b.circles([(x, y)], 2, [col], -1)
        elif kind == 1:
            cv2.rectangle(ref, (x - 5, y - 5), (x + 5, y + 5), col, 1)
            b.rectangles([(x - 5, y - 5)], [(x + 5, y + 5)], [col], 1)
        else:
            x1, y1 = (int(v) for v in rng.integers(-5, 85, 2))
            cv2.line(ref, (x, y), (x1, y1), col, 1)
            b.lines([(x, y)], [(x1, y1)], [col], 1)
    np.testing.assert_array_equal(b.paint(img), ref)


def _glyph_table():
    path = os.path.join(os.path.dirname(R.__file__), "hershey_glyphs.json")
    with open(path) as f:
        return json.load(f)


def test_glyph_table_recorded_equal_to_opencv4():
    doc = _glyph_table()
    assert doc["source"].startswith("recovered from cv2 4.")
    for face in ("0", "1"):
        font = doc["fonts"][face]
        assert font["pixel_equal_glyphs"] == 95
        assert sorted(font["glyphs"]) == [chr(c) for c in range(32, 127)]
        assert len(font["checked"]) == 8


def test_text_size_equals_opencv4():
    doc = _glyph_table()
    n = 0
    for face, font in doc["fonts"].items():
        for key, (w, h, base) in font["get_text_size"].items():
            text, scale, th = key.split("|")
            assert R.get_text_size(text, int(face), float(scale), int(th)) == ((w, h), base), key
            n += 1
    assert n == 40


@pytest.mark.parametrize("face", [R.FONT_HERSHEY_SIMPLEX, R.FONT_HERSHEY_PLAIN])
def test_text_stays_inside_its_strokes_box(face):
    font = _glyph_table()["fonts"][str(face)]
    rng = np.random.default_rng(face)
    for scale, th in ((1.0, 1), (0.7, 2), (0.5, 1), (1.3, 2)):
        for _ in range(10):
            text = "".join(rng.choice(list(string.printable[:95]), 8))
            img = np.zeros((200, 400, 3), np.uint8)
            org = (50, 120)
            R.put_text(img, text, org, face, scale, (255, 255, 255), th)
            xs, ys, adv = [], [], 0
            for c in text:
                g = font["glyphs"][c]
                for stroke in g["strokes"]:
                    for u, v in stroke:
                        xs.append(adv + u)
                        ys.append(v - font["base_line"])
                adv += g["advance"]
            py, px = np.nonzero(img[..., 0])
            if not len(px):
                continue
            pad = th // 2 + 1
            assert px.min() >= org[0] + min(xs) * scale - pad
            assert px.max() <= org[0] + max(xs) * scale + pad
            assert py.min() >= org[1] + min(ys) * scale - pad
            assert py.max() <= org[1] + max(ys) * scale + pad
