"""Grouped bar charts for the evaluation figures, without a plotting library.

The JAX package draws evaluate_batch's --viz figures and
examples/evaluate_viz.py's with matplotlib; the port draws the same files
(the same panels, sessions in the same order, one bar a mode and session,
grouped by session) with ``io/raster.py`` and writes them with
``io/png.py``. They are not matplotlib's pixels: labels are Hershey text, and
each bar's height is its value over the panel's top value, in whole pixels.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..io import raster
from ..io.png import write_png

SURFACE = (251, 252, 252)                   # BGR of #fcfcfb
INK, INK2, GRID = (11, 11, 11), (78, 81, 82), (223, 227, 228)
SERIES = [(214, 120, 42), (52, 104, 235)]    # BGR of #2a78d6, #eb6834
LEFT, RIGHT, TOP, BOTTOM = 90, 30, 50, 70     # panel margins, pixels


def _nice_top(vmax: float) -> float:
    """The axis top: the value rounded up to 1, 2 or 5 x a power of ten."""
    if not vmax > 0:
        return 1.0
    e = 10.0 ** np.floor(np.log10(vmax))
    for m in (1.0, 2.0, 5.0, 10.0):
        if vmax <= m * e:
            return m * e
    return 10.0 * e


def bar_panel(img, box, sessions: Sequence[str], modes: Sequence[str], values, title: str):
    """Draw one grouped-bar panel into `img` (BGR, in place) inside box =
    (x0, y0, x1, y1). values: (n_modes, n_sessions). Returns the bars as
    dicts (mode, session, value, x0, x1, top, bottom): a bar fills rows
    top..bottom-1, its height round(value / axis top x plot height)."""
    x0, y0, x1, y1 = box
    values = np.asarray(values, np.float64).reshape(len(modes), len(sessions))
    px0, py0, px1, py1 = x0 + LEFT, y0 + TOP, x1 - RIGHT, y1 - BOTTOM
    ph = py1 - py0
    top = _nice_top(float(values.max()) if values.size else 0.0)
    b = raster.Batch(img.shape)
    b.text(title, (x0 + 10, y0 + 30), raster.FONT_HERSHEY_SIMPLEX, 0.6, INK, 1)
    for k in range(6):                              # grid lines and their values
        y = py1 - int(round(ph * k / 5))
        b.lines([(px0, y)], [(px1, y)], [GRID], 1)
        b.text(f"{top * k / 5:.3g}", (x0 + 8, y + 5), raster.FONT_HERSHEY_PLAIN, 1.0, INK2, 1)
    n_s, n_m = len(sessions), len(modes)
    slot = (px1 - px0) / max(n_s, 1)
    width = 0.8 * slot / max(n_m, 1)
    bars = []
    for si, sess in enumerate(sessions):
        cx = px0 + slot * (si + 0.5)
        for mi, mode in enumerate(modes):
            bx = cx + (mi - (n_m - 1) / 2) * width
            bx0, bx1 = int(round(bx - 0.47 * width)), int(round(bx + 0.47 * width))
            h = int(round(values[mi, si] / top * ph))
            if h > 0:
                b.rectangles([(bx0, py1 - h)], [(bx1, py1 - 1)], [SERIES[mi % len(SERIES)]], -1)
            bars.append(dict(mode=mode, session=sess, value=float(values[mi, si]), x0=bx0,
                             x1=bx1, top=py1 - h, bottom=py1))
        (tw, _), _ = raster.get_text_size(sess, raster.FONT_HERSHEY_PLAIN, 1.0, 1)
        b.text(sess, (int(round(cx - tw / 2)), py1 + 22), raster.FONT_HERSHEY_PLAIN, 1.0, INK2, 1)
    if n_m > 1:                                     # the legend, top right
        lx = px1 - 150
        for mi, mode in enumerate(modes):
            ly = y0 + 18 + 20 * mi
            b.rectangles([(lx, ly)], [(lx + 12, ly + 12)], [SERIES[mi % len(SERIES)]], -1)
            b.text(mode, (lx + 20, ly + 12), raster.FONT_HERSHEY_PLAIN, 1.0, INK2, 1)
    b.paint(img)
    return bars


def figure(panels: List[dict], width: int, height: int, path: str):
    """Panels stacked vertically on one canvas, written as a PNG. Each panel:
    sessions, modes, values, title. Returns every panel's bars."""
    img = np.empty((height, width, 3), np.uint8)
    img[:] = SURFACE
    ph = height // len(panels)
    out = [bar_panel(img, (0, k * ph, width, (k + 1) * ph), p["sessions"], p["modes"],
                     p["values"], p["title"]) for k, p in enumerate(panels)]
    write_png(path, np.ascontiguousarray(img[..., ::-1]))
    return out


def sessions_by_failures(report: dict, modes: Sequence[str], sessions=None) -> List[str]:
    """SORT_TRAJ (evaluate_batch_viz.py:31-33): sessions by the first mode's
    failure count, most first, ties in the given order."""
    if sessions is None:
        sessions = [s for s in report.get(modes[0], {}) if s != "__aggregate__"]
    return sorted(sessions, key=lambda s: -report[modes[0]][s].get("failures", 0))


def values(report: dict, modes, sessions, key: str) -> np.ndarray:
    return np.array([[report.get(m, {}).get(s, {}).get(key, 0.0) for s in sessions]
                     for m in modes], np.float64)
