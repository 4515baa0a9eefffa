"""Raster drawing on BGR uint8 images, as OpenCV's ``imgproc/drawing.cpp``
draws.

The counterpart of the cv2 calls the JAX package's drawing code makes
(``introspection/vis.py``, ``slam/viewer.py``, ``slam/ar.py``): each
function takes and returns numpy images with cv2's argument conventions
(points as (x, y), colours as BGR tuples, ``thickness=-1`` fills). The port
imports no cv2.

The arithmetic is OpenCV's, found by probing cv2 5.0.0 and held against it
by ``tests/test_torch_raster.py``:

* ``line`` at thickness 1, LINE_8: ``LineIterator``'s Bresenham (8-connected,
  drawn left to right) after ``clipLine`` on the image rectangle;
* thicker lines: ``ThickLine``: the quadrilateral around the segment in
  16-bit fixed point (``FillConvexPoly``: its edges by ``Line2``, the
  fixed-point DDA, then its scanlines) and a filled ``Circle`` of radius
  (thickness + 1) // 2 on each end;
* ``circle`` filled or at thickness 1, LINE_8: ``Circle``'s midpoint
  algorithm; thicker: ``EllipseEx`` (``ellipse2Poly``'s polygon drawn as a
  thick polyline);
* ``rectangle``: a closed polyline of its four corners;
* ``arrowed_line``: the shaft and two tip strokes at +-45 degrees of
  ``tip_length`` times its length;
* ``put_text``: the Hershey fonts SIMPLEX and PLAIN, their glyphs' strokes
  (``hershey_glyphs.json``, recovered from cv2 by
  ``tools/hershey_extract.py``) drawn as polylines in 16-bit fixed point;
* LINE_AA: ``LineAA``'s three-pixel filter with end-point corrections, the
  thick form filling its polygon and round caps with anti-aliased edges;
* ``apply_colormap_jet``: COLORMAP_JET's 256 entries; ``add_weighted``:
  ``saturate_cast<uchar>`` of the float sum (round half to even).

Speed: a drawer draws thousands of primitives a frame, so primitives are
gathered in a ``Batch`` and painted in one numpy scatter: every primitive
yields its pixel set (vectorised over all primitives of one kind), and where
pixels of several primitives meet, the one drawn last wins, as it does
when cv2 draws them one after the other. Anti-aliased lines blend with what
lies below, so they are drawn one after the other (a few dozen a frame).
"""

from __future__ import annotations

import functools
import json
import math
import os

import numpy as np

LINE_8, LINE_AA = 8, 16
FONT_HERSHEY_SIMPLEX, FONT_HERSHEY_PLAIN = 0, 1

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
_HALF = XY_ONE >> 1


# ---------------------------------------------------------------- colour ops

def gray2bgr(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_GRAY2BGR): the grey value in all three
    channels."""
    g = np.asarray(img, np.uint8)
    return np.repeat(g[..., None], 3, axis=-1)


def _jet_lut() -> np.ndarray:
    i = np.arange(256)
    b = np.select([i < 32, i < 96, i < 160], [128 + 4 * i, 255, 254 - 4 * (i - 96)], 0)
    g = np.select([i < 32, i < 96, i < 160, i < 224], [0, 4 * (i - 32), 255, 252 - 4 * (i - 160)], 0)
    r = np.select([i < 96, i < 160, i < 224], [0, 2 + 4 * (i - 96), 255], 252 - 4 * (i - 224))
    # cv2 interpolates its float control points at 256 samples; the sample
    # of entry 159 falls just short of blue's last step
    b[159] = 1
    return np.stack([b, g, r], axis=1).astype(np.uint8)


JET_LUT = _jet_lut()


def apply_colormap_jet(img: np.ndarray) -> np.ndarray:
    """cv2.applyColorMap(img, COLORMAP_JET) of an (H, W) uint8 image:
    (H, W, 3) BGR."""
    return JET_LUT[np.asarray(img, np.uint8)]


def add_weighted(a: np.ndarray, alpha: float, b: np.ndarray, beta: float,
                 gamma: float = 0.0) -> np.ndarray:
    """cv2.addWeighted for uint8 images: the sum in float32, rounded half to
    even and saturated."""
    s = (np.asarray(a, np.float32) * np.float32(alpha)
         + np.asarray(b, np.float32) * np.float32(beta) + np.float32(gamma))
    return np.clip(np.rint(s), 0, 255).astype(np.uint8)


# ------------------------------------------------------- integer primitives

def _tdiv(a, b):
    """C's integer division (truncates toward zero) of int64 arrays."""
    q = np.abs(a) // np.abs(b)
    return np.where((a < 0) != (b < 0), -q, q)


def _clip_line(w, h, x1, y1, x2, y2):
    """OpenCV's clipLine on the rectangle [0, w-1] x [0, h-1], for int64
    arrays of end points; returns (keep, x1, y1, x2, y2)."""
    right, bottom = w - 1, h - 1
    x1, y1, x2, y2 = (np.array(v, np.int64) for v in (x1, y1, x2, y2))
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    todo = ((c1 & c2) == 0) & ((c1 | c2) != 0)
    f = np.float64

    def safe(d):
        return np.where(d == 0, 1, d)

    m = todo & ((c1 & 12) != 0)
    a = np.where(c1 < 8, 0, bottom)
    nx = x1 + np.trunc((a - y1).astype(f) * (x2 - x1).astype(f) / safe(y2 - y1).astype(f)).astype(np.int64)
    x1 = np.where(m, nx, x1)
    y1 = np.where(m, a, y1)
    c1 = np.where(m, (x1 < 0) + (x1 > right) * 2, c1)
    m = todo & ((c2 & 12) != 0)
    a = np.where(c2 < 8, 0, bottom)
    nx = x2 + np.trunc((a - y2).astype(f) * (x2 - x1).astype(f) / safe(y2 - y1).astype(f)).astype(np.int64)
    x2 = np.where(m, nx, x2)
    y2 = np.where(m, a, y2)
    c2 = np.where(m, (x2 < 0) + (x2 > right) * 2, c2)
    todo2 = todo & ((c1 & c2) == 0) & ((c1 | c2) != 0)
    m = todo2 & (c1 != 0)
    a = np.where(c1 == 1, 0, right)
    ny = y1 + np.trunc((a - x1).astype(f) * (y2 - y1).astype(f) / safe(x2 - x1).astype(f)).astype(np.int64)
    y1 = np.where(m, ny, y1)
    x1 = np.where(m, a, x1)
    c1 = np.where(m, 0, c1)
    m = todo2 & (c2 != 0)
    a = np.where(c2 == 1, 0, right)
    ny = y2 + np.trunc((a - x2).astype(f) * (y2 - y1).astype(f) / safe(x2 - x1).astype(f)).astype(np.int64)
    y2 = np.where(m, ny, y2)
    x2 = np.where(m, a, x2)
    c2 = np.where(m, 0, c2)
    return (c1 | c2) == 0, x1, y1, x2, y2


def _expand(counts):
    """(owner, step) of every element when item i has counts[i] elements."""
    counts = np.asarray(counts, np.int64)
    owner = np.repeat(np.arange(len(counts)), counts)
    start = np.cumsum(counts) - counts
    return owner, np.arange(int(counts.sum())) - start[owner]


def _bresenham(w, h, x1, y1, x2, y2):
    """Line(): LineIterator's 8-connected pixels of integer segments, clipped
    to the image. Returns (owner, x, y)."""
    keep, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
    swap = x2 < x1                              # drawn left to right
    x1, x2 = np.where(swap, x2, x1), np.where(swap, x1, x2)
    y1, y2 = np.where(swap, y2, y1), np.where(swap, y1, y2)
    dx, dy = x2 - x1, y2 - y1
    sy = np.where(dy < 0, -1, 1)
    dy = np.abs(dy)
    vert = dy > dx
    major, minor = np.where(vert, dy, dx), np.where(vert, dx, dy)
    owner, k = _expand(np.where(keep, major + 1, 0))
    M, m = major[owner], minor[owner]
    # the error recursion's minor steps after k major ones, in closed form
    mk = -((M - 2 * m * k) // np.maximum(2 * M, 1))
    v = vert[owner]
    x = x1[owner] + np.where(v, mk, k)
    y = y1[owner] + sy[owner] * np.where(v, k, mk)
    return owner, x, y


def _line2(w, h, p1x, p1y, p2x, p2y):
    """Line2(): the fixed-point DDA of segments given in XY_SHIFT fixed
    point, clipped to the image. Returns (owner, x, y)."""
    keep, p1x, p1y, p2x, p2y = _clip_line(np.int64(w) << XY_SHIFT, np.int64(h) << XY_SHIFT,
                                          p1x, p1y, p2x, p2y)
    dx, dy = p2x - p1x, p2y - p1y
    ax, ay = np.abs(dx), np.abs(dy)
    horiz = ax > ay
    sw = np.where(horiz, dx < 0, dy < 0)
    a1x, a1y = np.where(sw, p2x, p1x), np.where(sw, p2y, p1y)
    a2x, a2y = np.where(sw, p1x, p2x), np.where(sw, p1y, p2y)
    ddx, ddy = a2x - a1x, a2y - a1y
    y_step = _tdiv(ddy << XY_SHIFT, ax | 1)
    x_step = _tdiv(ddx << XY_SHIFT, ay | 1)
    ecount = np.where(horiz, (a2x - a1x) >> XY_SHIFT, (a2y - a1y) >> XY_SHIFT)
    s1x, s1y = a1x + _HALF, a1y + _HALF
    owner, k = _expand(np.where(keep, ecount + 1, 0))
    hz = horiz[owner]
    x = np.where(hz, (s1x[owner] >> XY_SHIFT) + k, (s1x[owner] + k * x_step[owner]) >> XY_SHIFT)
    y = np.where(hz, (s1y[owner] + k * y_step[owner]) >> XY_SHIFT, (s1y[owner] >> XY_SHIFT) + k)
    kept = np.nonzero(keep)[0]
    ex = (a2x[kept] + _HALF) >> XY_SHIFT
    ey = (a2y[kept] + _HALF) >> XY_SHIFT
    owner = np.concatenate([kept, owner])
    x, y = np.concatenate([ex, x]), np.concatenate([ey, y])
    inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    return owner[inside], x[inside], y[inside]


@functools.lru_cache(maxsize=64)
def _circle_offsets(radius: int, fill: bool):
    """Circle()'s pixels of a circle at the origin: (dx, dy) int64 arrays."""
    pts = set()
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for (xa, xb, y) in ((-dx, dx, -dy), (-dx, dx, dy), (-dy, dy, -dx), (-dy, dy, dx)):
            if fill:
                pts.update((x, y) for x in range(xa, xb + 1))
            else:
                pts.update(((xa, y), (xb, y)))
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    arr = np.array(sorted(pts), np.int64).reshape(-1, 2)
    return arr[:, 0], arr[:, 1]


def _circle_px(w, h, cx, cy, radius: int, fill: bool):
    ox, oy = _circle_offsets(int(radius), bool(fill))
    n = len(cx)
    owner = np.repeat(np.arange(n), len(ox))
    x = (np.asarray(cx, np.int64)[:, None] + ox[None, :]).reshape(-1)
    y = (np.asarray(cy, np.int64)[:, None] + oy[None, :]).reshape(-1)
    inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    return owner[inside], x[inside], y[inside]


def _fill_convex(w, h, v, aa: bool = False):
    """FillConvexPoly() of N polygons of P vertices in XY_SHIFT fixed point,
    v: (N, P, 2) int64. Returns (edge pixels (owner, x, y), spans (owner,
    y, x0, x1)). With aa the edges are LineAA's and come back as
    (owner, x, y, alpha) through `_line_aa_px`; spans use its rounding."""
    v = np.asarray(v, np.int64)
    n, npts = v.shape[:2]
    if aa:
        edges = _line_aa_px(w, h, np.roll(v[:, :, 0], 1, axis=1).reshape(-1),
                            np.roll(v[:, :, 1], 1, axis=1).reshape(-1),
                            v[:, :, 0].reshape(-1), v[:, :, 1].reshape(-1))
        delta1, delta2 = XY_ONE - 1, 0       # owner: the edge, n * npts of them
    else:
        o, x, y = _line2(w, h, np.roll(v[:, :, 0], 1, axis=1).reshape(-1),
                         np.roll(v[:, :, 1], 1, axis=1).reshape(-1),
                         v[:, :, 0].reshape(-1), v[:, :, 1].reshape(-1))
        edges = (o // npts, x, y)
        delta1 = delta2 = _HALF
    vx, vy = v[:, :, 0], v[:, :, 1]
    imin = np.argmin(vy, axis=1)
    xmin = (vx.min(1) + _HALF) >> XY_SHIFT
    xmax = (vx.max(1) + _HALF) >> XY_SHIFT
    ymin = (vy.min(1) + _HALF) >> XY_SHIFT
    ymax = (vy.max(1) + _HALF) >> XY_SHIFT
    live = ~((npts < 3) | (xmax < 0) | (ymax < 0) | (xmin >= w) | (ymin >= h))
    ymax = np.minimum(ymax, h - 1)
    rows = np.arange(n)
    idx = np.stack([imin, imin], 1)
    di = np.array([1, npts - 1])
    ye = np.stack([ymin, ymin], 1)
    ex = np.full((n, 2), -XY_ONE, np.int64)
    edx = np.zeros((n, 2), np.int64)
    edges_left = np.full(n, npts, np.int64)
    y = ymin.copy()
    out = []
    tyv = (vy + _HALF) >> XY_SHIFT
    while live.any():
        check = live if not aa else live & ((y < ymax) | (y == ymin))
        for i in range(2):
            need = check & (y >= ye[:, i])
            idx0 = idx[:, i].copy()
            cur = (idx0 + di[i]) % npts
            searching = need.copy()
            for _ in range(npts + 1):
                if not searching.any():
                    break
                edges_left = np.where(searching, edges_left - 1, edges_left)
                ok = searching & (edges_left >= 0)
                searching &= ok
                ty = tyv[rows, cur]
                hit = searching & (ty > y)
                if hit.any():
                    xs, xe = vx[rows, idx0], vx[rows, cur]
                    d = np.where(hit, ty - y, 1)
                    ye[:, i] = np.where(hit, ty, ye[:, i])
                    edx[:, i] = np.where(hit, _tdiv((xe - xs) * 2 + d, 2 * d), edx[:, i])
                    ex[:, i] = np.where(hit, xs, ex[:, i])
                    idx[:, i] = np.where(hit, cur, idx[:, i])
                searching &= ~hit
                idx0 = np.where(searching, cur, idx0)
                cur = np.where(searching, (cur + di[i]) % npts, cur)
        live &= edges_left >= 0
        left = np.where(ex[:, 0] > ex[:, 1], 1, 0)
        xl = ex[rows, left]
        xr = ex[rows, 1 - left]
        xx1 = (xl + delta1) >> XY_SHIFT
        xx2 = (xr + delta2) >> XY_SHIFT
        draw = live & (y >= 0) & (xx2 >= 0) & (xx1 < w)
        if draw.any():
            k = np.nonzero(draw)[0]
            out.append((k, y[k], np.maximum(xx1[k], 0), np.minimum(xx2[k], w - 1)))
        ex += edx
        y = y + 1
        live &= y <= ymax
    if out:
        spans = tuple(np.concatenate(c) for c in zip(*out))
    else:
        spans = tuple(np.zeros(0, np.int64) for _ in range(4))
    return edges, spans


def _span_px(spans):
    owner, y, x0, x1 = spans
    o, k = _expand(np.maximum(x1 - x0 + 1, 0))
    return owner[o], x0[o] + k, y[o]


def _thick_segments(w, h, p0x, p0y, p1x, p1y, thickness: int, caps0, caps1):
    """ThickLine() at thickness > 1, LINE_8, end points in XY_SHIFT fixed
    point: the segments' quadrilaterals and the round caps where asked.
    Returns (owner, x, y)."""
    dx = (p0x - p1x) * (1.0 / XY_ONE)
    dy = (p1y - p0y) * (1.0 / XY_ONE)
    r = dx * dx + dy * dy
    t = thickness << (XY_SHIFT - 1)
    odd = thickness & 1
    ok = np.abs(r) > np.finfo(np.float64).eps
    rr = (t + odd * XY_ONE * 0.5) / np.sqrt(np.where(ok, r, 1.0))
    dpx = np.rint(dy * rr).astype(np.int64)
    dpy = np.rint(dx * rr).astype(np.int64)
    poly = np.stack([np.stack([p0x + dpx, p0y + dpy], -1), np.stack([p0x - dpx, p0y - dpy], -1),
                     np.stack([p1x - dpx, p1y - dpy], -1), np.stack([p1x + dpx, p1y + dpy], -1)],
                    axis=1)
    k = np.nonzero(ok)[0]
    (eo, ex_, ey), spans = _fill_convex(w, h, poly[k])
    so, sx, sy = _span_px(spans)
    owner = [k[eo], k[so]]
    xs, ys = [ex_, sx], [ey, sy]
    rad = (t + _HALF) >> XY_SHIFT
    for caps, px, py in ((caps0, p0x, p0y), (caps1, p1x, p1y)):
        c = np.nonzero(caps)[0]
        if len(c):
            co, cx, cy = _circle_px(w, h, (px[c] + _HALF) >> XY_SHIFT, (py[c] + _HALF) >> XY_SHIFT,
                                    rad, True)
            owner.append(c[co])
            xs.append(cx)
            ys.append(cy)
    return np.concatenate(owner), np.concatenate(xs), np.concatenate(ys)


def _segments_px(w, h, p0x, p0y, p1x, p1y, thickness: int, shift: int, caps0=None, caps1=None):
    """ThickLine() of LINE_8 segments whose end points carry `shift`
    fractional bits. Returns (owner, x, y)."""
    s = XY_SHIFT - shift
    p0x, p0y, p1x, p1y = (np.asarray(a, np.int64) << s for a in (p0x, p0y, p1x, p1y))
    if thickness <= 1:
        r = [(a + _HALF) >> XY_SHIFT for a in (p0x, p0y, p1x, p1y)]
        return _bresenham(w, h, *r)
    n = len(p0x)
    caps0 = np.ones(n, bool) if caps0 is None else caps0
    caps1 = np.ones(n, bool) if caps1 is None else caps1
    return _thick_segments(w, h, p0x, p0y, p1x, p1y, thickness, caps0, caps1)


# ------------------------------------------------------------------- ellipses

def _sin_table():
    # drawing.cpp's SinTable: sin of every whole degree 0..450, as 7-decimal
    # float literals
    return np.array([float(np.float32(round(math.sin(math.radians(d)), 7))) for d in range(451)])


SIN_TABLE = _sin_table()


def _ellipse2poly(cx, cy, ax, ay, delta):
    """ellipse2Poly() of a full, unrotated ellipse, centre and axes as
    doubles: the (K, 2) float64 points."""
    pts = []
    for i in range(0, 360 + delta, delta):
        a = min(i, 360)
        pts.append((cx + ax * SIN_TABLE[450 - a], cy + ay * SIN_TABLE[a]))
    return pts


def _ellipse_fixed(cx, cy, radius):
    """EllipseEx()'s polygon of a circle given in XY_SHIFT fixed point:
    (K, 2) int64 points, consecutive duplicates dropped."""
    delta = (radius + _HALF) >> XY_SHIFT
    delta = 90 if delta < 3 else 30 if delta < 10 else 18 if delta < 15 else 5
    out = []
    for x, y in _ellipse2poly(float(cx), float(cy), float(radius), float(radius), delta):
        px = int(np.rint(x / XY_ONE)) << XY_SHIFT
        py = int(np.rint(y / XY_ONE)) << XY_SHIFT
        px += int(np.rint(x - px))
        py += int(np.rint(y - py))
        if not out or out[-1] != (px, py):
            out.append((px, py))
    if len(out) == 1:
        out = [(cx, cy), (cx, cy)]
    return np.array(out, np.int64)


# ---------------------------------------------------------------- the fonts

@functools.lru_cache(maxsize=1)
def _fonts():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "hershey_glyphs.json")
    with open(path) as f:
        doc = json.load(f)
    return {int(k): v for k, v in doc["fonts"].items()}


def _font(face: int):
    fonts = _fonts()
    if face not in fonts:
        raise ValueError(f"font {face}: only FONT_HERSHEY_SIMPLEX (0) and "
                         f"FONT_HERSHEY_PLAIN (1) are drawn")
    return fonts[face]


def _glyph(font, c: str):
    g = font["glyphs"].get(c)
    if g is None:
        g = font["glyphs"]["?"]       # cv2 draws '?' for what its table lacks
    return g


def get_text_size(text: str, font_face: int, font_scale: float, thickness: int):
    """cv2.getTextSize: ((width, height), baseline)."""
    font = _font(font_face)
    base, cap = font["base_line"], font["cap_line"]
    height = int(np.rint((cap + base) * font_scale + (thickness + 1) // 2))
    view_x = 0.0
    for c in text:
        view_x += _glyph(font, c)["advance"] * font_scale
    return (int(np.rint(view_x + thickness)), height), int(np.rint(base * font_scale + thickness * 0.5))


def _text_polylines(text, font_face, font_scale, org, bottom_left_origin=False):
    """The strokes of `text` as polylines in XY_SHIFT fixed point, as
    putText() places them."""
    font = _font(font_face)
    hscale = int(np.rint(font_scale * XY_ONE))
    vscale = -hscale if bottom_left_origin else hscale
    view_x = int(org[0]) << XY_SHIFT
    view_y = (int(org[1]) << XY_SHIFT) - font["base_line"] * vscale
    lines = []
    for c in text:
        g = _glyph(font, c)
        for stroke in g["strokes"]:
            if len(stroke) > 1:
                lines.append([(view_x + x * hscale, view_y + y * vscale) for x, y in stroke])
        view_x += g["advance"] * hscale
    return lines


# ------------------------------------------------------------------ batches

class Batch:
    """Solid-colour primitives gathered for one scatter onto an (H, W, 3)
    image. Each primitive gets a key, by default the next in call order;
    where primitives overlap, the one with the larger key wins, as the one
    drawn later does in cv2. ``paint(img)`` writes them all."""

    def __init__(self, shape):
        self.h, self.w = int(shape[0]), int(shape[1])
        self._flat, self._key, self._colors = [], [], []
        self._next = 0

    def _keys(self, n, keys):
        if keys is None:
            keys = np.arange(self._next, self._next + n)
        keys = np.asarray(keys, np.int64)
        self._next = max(self._next, int(keys.max()) + 1) if n else self._next
        return keys

    def _add(self, owner, x, y, keys, colors):
        n = len(keys)
        colors = np.asarray(colors, np.int64).reshape(-1, 3)
        colors = np.broadcast_to(colors, (n, 3)) if len(colors) == 1 else colors
        self._flat.append(y * self.w + x)
        self._key.append(keys[owner])
        self._colors.append((keys, colors))

    def circles(self, centers, radius: int, colors, thickness: int = 1, keys=None):
        """cv2.circle at each (x, y) centre (LINE_8; thickness -1 fills)."""
        c = np.asarray(centers, np.int64).reshape(-1, 2)
        keys = self._keys(len(c), keys)
        if thickness < 0 or thickness == 1:
            o, x, y = _circle_px(self.w, self.h, c[:, 0], c[:, 1], radius, thickness < 0)
        else:
            owner, xs, ys = [], [], []
            for i, (cx, cy) in enumerate(c):
                poly = _ellipse_fixed(int(cx) << XY_SHIFT, int(cy) << XY_SHIFT,
                                      int(radius) << XY_SHIFT)
                m = len(poly) - 1
                caps0 = np.zeros(m, bool)
                caps0[0] = True
                oo, xx, yy = _segments_px(self.w, self.h, poly[:-1, 0], poly[:-1, 1], poly[1:, 0],
                                          poly[1:, 1], thickness, XY_SHIFT, caps0,
                                          np.ones(m, bool))
                owner.append(np.full(len(oo), i))
                xs.append(xx)
                ys.append(yy)
            o, x, y = (np.concatenate(a) for a in (owner, xs, ys))
        self._add(o, x, y, keys, colors)

    def lines(self, p0, p1, colors, thickness: int = 1, shift: int = 0, keys=None):
        """cv2.line for each pair of end points (LINE_8)."""
        p0 = np.asarray(p0, np.int64).reshape(-1, 2)
        p1 = np.asarray(p1, np.int64).reshape(-1, 2)
        keys = self._keys(len(p0), keys)
        o, x, y = self._line_px(p0, p1, thickness, shift)
        self._add(o, x, y, keys, colors)

    def _line_px(self, p0, p1, thickness, shift):
        """line()'s pixels: a thick segment is first clipped to the image
        grown by the thickness on every side (whole pixels), then ThickLine."""
        t = int(thickness)
        if shift == 0 and t > 1:
            keep, x0, y0, x1, y1 = _clip_line(self.w + 2 * t, self.h + 2 * t, p0[:, 0] + t,
                                              p0[:, 1] + t, p1[:, 0] + t, p1[:, 1] + t)
            k = np.nonzero(keep)[0]
            o, x, y = _segments_px(self.w, self.h, x0[k] - t, y0[k] - t, x1[k] - t, y1[k] - t,
                                   thickness, 0)
            return k[o], x, y
        return _segments_px(self.w, self.h, p0[:, 0], p0[:, 1], p1[:, 0], p1[:, 1],
                            thickness, shift)

    def arrowed_lines(self, p0, p1, colors, thickness: int = 1, tip_length: float = 0.1,
                      keys=None):
        """cv2.arrowedLine for each pair (LINE_8, shift 0)."""
        p0 = np.asarray(p0, np.int64).reshape(-1, 2)
        p1 = np.asarray(p1, np.int64).reshape(-1, 2)
        n = len(p0)
        keys = self._keys(n, keys)
        d = (p0 - p1).astype(np.float64)
        tip = np.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2) * tip_length
        ang = np.arctan2(d[:, 1], d[:, 0])
        heads = [np.stack([np.rint(p1[:, 0] + tip * np.cos(ang + s * math.pi / 4)),
                           np.rint(p1[:, 1] + tip * np.sin(ang + s * math.pi / 4))],
                          1).astype(np.int64) for s in (1, -1)]
        a = np.concatenate([p0, heads[0], heads[1]])
        b = np.concatenate([p1, p1, p1])
        o, x, y = self._line_px(a, b, thickness, 0)
        self._add(o % n, x, y, keys, colors)

    def rectangles(self, p0, p1, colors, thickness: int = 1, keys=None):
        """cv2.rectangle between opposite corners (LINE_8; thickness -1
        fills)."""
        p0 = np.asarray(p0, np.int64).reshape(-1, 2)
        p1 = np.asarray(p1, np.int64).reshape(-1, 2)
        n = len(p0)
        keys = self._keys(n, keys)
        x0, y0, x1, y1 = p0[:, 0], p0[:, 1], p1[:, 0], p1[:, 1]
        if thickness < 0:
            poly = np.stack([np.stack(c, -1) << XY_SHIFT
                             for c in ((x0, y0), (x1, y0), (x1, y1), (x0, y1))], 1)
            (eo, ex_, ey), spans = _fill_convex(self.w, self.h, poly)
            so, sx, sy = _span_px(spans)
            o, x, y = np.concatenate([eo, so]), np.concatenate([ex_, sx]), np.concatenate([ey, sy])
        else:
            cx = np.stack([x0, x1, x1, x0], 1)
            cy = np.stack([y0, y0, y1, y1], 1)
            a = np.stack([np.roll(cx, 1, 1), np.roll(cy, 1, 1)], -1).reshape(-1, 2)
            b = np.stack([cx, cy], -1).reshape(-1, 2)
            o, x, y = _segments_px(self.w, self.h, a[:, 0], a[:, 1], b[:, 0], b[:, 1], thickness,
                                   0, np.zeros(4 * n, bool), np.ones(4 * n, bool))
            o = o // 4
        self._add(o, x, y, keys, colors)

    def text(self, text: str, org, font_face: int, font_scale: float, color,
             thickness: int = 1, key=None):
        """cv2.putText (LINE_8)."""
        keys = self._keys(1, None if key is None else [key])
        segs = []
        for pl in _text_polylines(text, font_face, font_scale, org):
            pl = np.array(pl, np.int64)
            caps0 = np.zeros(len(pl) - 1, bool)
            caps0[0] = True
            segs.append((pl[:-1], pl[1:], caps0))
        if not segs:
            return
        a = np.concatenate([s[0] for s in segs])
        b = np.concatenate([s[1] for s in segs])
        caps0 = np.concatenate([s[2] for s in segs])
        o, x, y = _segments_px(self.w, self.h, a[:, 0], a[:, 1], b[:, 0], b[:, 1], thickness,
                               XY_SHIFT, caps0, np.ones(len(a), bool))
        self._add(np.zeros_like(o), x, y, keys, [color])

    def paint(self, img: np.ndarray) -> np.ndarray:
        """Write every primitive into `img` (in place) and return it."""
        if not self._flat:
            return img
        flat = np.concatenate(self._flat)
        key = np.concatenate(self._key)
        table = np.zeros((self._next, 3), np.int64)
        for keys, colors in self._colors:
            table[keys] = colors
        code = np.unique((flat << 32) | key)
        px = code >> 32
        last = np.ones(len(code), bool)
        last[:-1] = px[1:] != px[:-1]
        img.reshape(-1, img.shape[-1])[px[last]] = table[code[last] & 0xFFFFFFFF].astype(img.dtype)
        self._flat, self._key, self._colors = [], [], []
        return img


# ------------------------------------------------------ cv2-style one-shots

def _check(img):
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3 or not img.flags.c_contiguous:
        raise ValueError("draws on a C-contiguous (H, W, 3) uint8 image")


def circle(img, center, radius, color, thickness=1, line_type=LINE_8):
    """cv2.circle, in place; returns img."""
    _check(img)
    if line_type != LINE_8:
        raise ValueError("circle: LINE_8 only")
    b = Batch(img.shape)
    b.circles([center], int(radius), [color], thickness)
    return b.paint(img)


def line(img, pt1, pt2, color, thickness=1, line_type=LINE_8):
    """cv2.line, in place; returns img."""
    _check(img)
    if line_type == LINE_AA:
        return lines_aa(img, [pt1], [pt2], [color], thickness)
    b = Batch(img.shape)
    b.lines([pt1], [pt2], [color], thickness)
    return b.paint(img)


def arrowed_line(img, pt1, pt2, color, thickness=1, line_type=LINE_8, tip_length=0.1):
    """cv2.arrowedLine, in place; returns img."""
    _check(img)
    b = Batch(img.shape)
    b.arrowed_lines([pt1], [pt2], [color], thickness, tip_length)
    return b.paint(img)


def rectangle(img, pt1, pt2, color, thickness=1, line_type=LINE_8):
    """cv2.rectangle, in place; returns img."""
    _check(img)
    b = Batch(img.shape)
    b.rectangles([pt1], [pt2], [color], thickness)
    return b.paint(img)


def put_text(img, text, org, font_face, font_scale, color, thickness=1, line_type=LINE_8):
    """cv2.putText (LINE_8), in place; returns img."""
    _check(img)
    b = Batch(img.shape)
    b.text(text, org, font_face, font_scale, color, thickness)
    return b.paint(img)


# --------------------------------------------------------------- anti-alias

SLOPE_CORR = np.array([181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190, 192, 194, 196,
                       198, 201, 203, 206, 209, 211, 214, 218, 221, 224, 227, 231, 235, 238,
                       242, 246, 250, 254], np.int64)
FILTER = np.array([168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246, 249, 252, 254,
                   254, 254, 254, 252, 249, 246, 241, 236, 231, 224, 218, 210, 202, 194, 185,
                   177, 168, 158, 149, 140, 131, 122, 114, 105, 97, 89, 82, 75, 68, 62, 56, 50,
                   45, 40, 36, 32, 28, 25, 22, 19, 16, 14, 12, 11, 9, 8, 7, 5, 5], np.int64)


def _line_aa_px(w, h, p1x, p1y, p2x, p2y):
    """LineAA(): pixels and 8-bit weights of segments in XY_SHIFT fixed
    point. Returns (owner, x, y, alpha); a segment's pixels are distinct."""
    keep, p1x, p1y, p2x, p2y = _clip_line(np.int64(w) << XY_SHIFT, np.int64(h) << XY_SHIFT,
                                          p1x, p1y, p2x, p2y)
    outs = []
    for s in np.nonzero(keep)[0]:
        outs.append(_line_aa_one(w, h, int(p1x[s]), int(p1y[s]), int(p2x[s]), int(p2y[s]), s))
    if not outs:
        z = np.zeros(0, np.int64)
        return z, z, z, z
    return tuple(np.concatenate(c) for c in zip(*outs))


def _line_aa_one(w, h, x1, y1, x2, y2, owner):
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            x1, x2, y1, y2 = x2, x1, y2, y1
            dy = -dy
        y_step = int(_tdiv(np.int64(dy << XY_SHIFT), np.int64(ax | 1)))
        x2 += XY_ONE
        ecount = (x2 >> XY_SHIFT) - (x1 >> XY_SHIFT)
        j = -(x1 & (XY_ONE - 1))
        y1 += ((y_step * j) >> XY_SHIFT) + _HALF
        slope = (y_step >> (XY_SHIFT - 5)) & 0x3F
        slope ^= 0x3F if y_step < 0 else 0
        i = (x1 >> (XY_SHIFT - 7)) & 0x78
        j = (x2 >> (XY_SHIFT - 7)) & 0x78
    else:
        if dy < 0:
            x1, x2, y1, y2 = x2, x1, y2, y1
            dx = -dx
        x_step = int(_tdiv(np.int64(dx << XY_SHIFT), np.int64(ay | 1)))
        y2 += XY_ONE
        ecount = (y2 >> XY_SHIFT) - (y1 >> XY_SHIFT)
        j = -(y1 & (XY_ONE - 1))
        x1 += ((x_step * j) >> XY_SHIFT) + _HALF
        slope = (x_step >> (XY_SHIFT - 5)) & 0x3F
        slope ^= 0x3F if x_step < 0 else 0
        i = (y1 >> (XY_SHIFT - 7)) & 0x78
        j = (y2 >> (XY_SHIFT - 7)) & 0x78
    slope = 0x100 if slope & 0x20 else int(SLOPE_CORR[slope])
    t0 = slope << 7
    t1 = ((0x78 - i) | 4) * slope
    t2 = (j | 4) * slope
    ep = [0] * 9
    ep[8] = slope
    ep[1] = ep[3] = ((((j - i) & 0x78) | 4) * slope >> 8) & 0x1FF
    ep[2] = (t1 >> 8) & 0x1FF
    ep[4] = ((((j - i) + 0x80) | 4) * slope >> 8) & 0x1FF
    ep[5] = ((t1 + t0) >> 8) & 0x1FF
    ep[6] = (t2 >> 8) & 0x1FF
    ep[7] = ((t2 + t0) >> 8) & 0x1FF
    ep = np.array(ep, np.int64)
    k = np.arange(ecount + 1, dtype=np.int64)
    sc, ec = k, ecount - k
    corr = ep[(((sc >= 2) + 1) & (sc | 2)) * 3 + (((ec >= 2) + 1) & (ec | 2))]
    if ax > ay:
        major = (x1 >> XY_SHIFT) + k
        minor_fp = y1 + k * y_step
        size_major, size_minor = w, h
    else:
        major = (y1 >> XY_SHIFT) + k
        minor_fp = x1 + k * x_step
        size_major, size_minor = h, w
    dist = (minor_fp >> (XY_SHIFT - 5)) & 31
    base = (minor_fp >> XY_SHIFT) - 1
    ok = (major >= 0) & (major < size_major)
    parts = []
    for off, filt in ((0, FILTER[dist + 32]), (1, FILTER[dist]), (2, FILTER[63 - dist])):
        mn = base + off
        a = (corr * filt >> 8) & 0xFF
        m = ok & (mn >= 0) & (mn < size_minor)
        parts.append((major[m], mn[m], a[m]))
    mj = np.concatenate([p[0] for p in parts])
    mn = np.concatenate([p[1] for p in parts])
    al = np.concatenate([p[2] for p in parts])
    x, y = (mj, mn) if ax > ay else (mn, mj)
    return np.full(len(x), owner, np.int64), x, y, al


def _blend(img, x, y, alpha, color):
    """LineAA's ICV_PUT_POINT: each channel moves toward the colour twice."""
    px = img[y, x].astype(np.int64)
    c = np.asarray(color, np.int64)[None, :]
    a = alpha[:, None]
    px += ((c - px) * a + 127) >> 8
    px += ((c - px) * a + 127) >> 8
    img[y, x] = px.astype(np.uint8)


def lines_aa(img, p0, p1, colors, thickness: int = 1):
    """cv2.line with LINE_AA for each pair of integer end points, one after
    the other (each blends with what lies below), in place; returns img."""
    _check(img)
    h, w = img.shape[:2]
    p0 = np.asarray(p0, np.int64).reshape(-1, 2)
    p1 = np.asarray(p1, np.int64).reshape(-1, 2)
    colors = np.broadcast_to(np.asarray(colors, np.int64).reshape(-1, 3), (len(p0), 3))
    t = int(thickness)
    if t > 1:           # line()'s clip to the image grown by the thickness
        keep, x0, y0, x1, y1 = _clip_line(w + 2 * t, h + 2 * t, p0[:, 0] + t, p0[:, 1] + t,
                                          p1[:, 0] + t, p1[:, 1] + t)
        p0 = np.stack([x0, y0], 1) - t
        p1 = np.stack([x1, y1], 1) - t
    else:
        keep = np.ones(len(p0), bool)
    p0, p1 = p0 << XY_SHIFT, p1 << XY_SHIFT
    for s in np.nonzero(keep)[0]:
        a, b, col = p0[s], p1[s], colors[s]
        if thickness <= 1:
            _, x, y, al = _line_aa_px(w, h, a[:1], a[1:], b[:1], b[1:])
            _blend(img, x, y, al, col)
            continue
        dx = (a[0] - b[0]) * (1.0 / XY_ONE)
        dy = (b[1] - a[1]) * (1.0 / XY_ONE)
        r = dx * dx + dy * dy
        t = thickness << (XY_SHIFT - 1)
        if abs(r) > np.finfo(np.float64).eps:
            rr = (t + (thickness & 1) * XY_ONE * 0.5) / math.sqrt(r)
            dpx, dpy = int(np.rint(dy * rr)), int(np.rint(dx * rr))
            poly = np.array([[[a[0] + dpx, a[1] + dpy], [a[0] - dpx, a[1] - dpy],
                              [b[0] - dpx, b[1] - dpy], [b[0] + dpx, b[1] + dpy]]], np.int64)
            _fill_aa(img, poly, col)
        for c in (a, b):
            cap = _ellipse_fixed(int(c[0]), int(c[1]), t)
            _fill_aa(img, cap[None], col)
    return img


def _fill_aa(img, poly, color):
    """FillConvexPoly() with LINE_AA: blended edges one after the other,
    then solid spans."""
    h, w = img.shape[:2]
    (eo, ex_, ey, al), spans = _fill_convex(w, h, poly, aa=True)
    for e in np.unique(eo):
        m = eo == e
        _blend(img, ex_[m], ey[m], al[m], color)
    _, sx, sy = _span_px(spans)
    img[sy, sx] = np.asarray(color, np.uint8)
