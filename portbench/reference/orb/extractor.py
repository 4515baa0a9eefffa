"""ORB feature extraction (ComputeKeyPointsOld, ORBextractor.cc:880-1296),
plain PyTorch.

pyramid -> FAST on all levels -> cell-local NMS and the iniTh/minTh
per-cell choice -> per-cell budgets, weighted by the introspection cost
map when one is given -> one budget-redistribution pass -> per-cell and
per-level retain-best -> IC orientation + 7x7/sigma2 Gaussian blur +
rBRIEF over the flattened pyramid canvas -> level-0 coordinates.

Two selection paths give the same keypoints on unweighted responses: the
histogram path (``select_path="hist"``) and the top-k path (stable
descending sorts that keep the lower index first on ties). A quality map
(uint8 cost, 255 = worst) scales each response by its pixel's quality and
always takes the top-k path. Each level emits exactly
``features_per_level[l]`` slots with a validity mask; the left/right pair
is a batch dimension B.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import image, numerics, pyramid
from .config import ORBConfig
from .plain_kernels import fast_score_levels, orient_brief
from .stereo import flatten_pyramid

EDGE_THRESHOLD = 19


class Keypoints(NamedTuple):
    """Padded per-image keypoint bundle (total capacity = sum of per-level
    budgets = cfg.n_features). Invalid slots have valid=False. With a
    leading batch dimension when produced by the batched path."""

    xy: torch.Tensor        # (N, 2) float32, level-0 pixel coords (x, y)
    response: torch.Tensor  # (N,) float32
    octave: torch.Tensor    # (N,) int32 pyramid level
    angle: torch.Tensor     # (N,) float32 degrees
    desc: torch.Tensor      # (N, 32) uint8 rBRIEF
    valid: torch.Tensor     # (N,) bool
    yx_level: torch.Tensor  # (N, 2) int32 integer coords at native level (row, col)

    @property
    def n(self) -> torch.Tensor:
        return torch.sum(self.valid)


@dataclass(frozen=True)
class LevelLayout:
    """Static per-level extraction geometry (ORBextractor.cc:884-927)."""

    h: int
    w: int
    n_desired: int
    level_cols: int
    level_rows: int
    cell_w: int
    cell_h: int

    @property
    def n_cells(self) -> int:
        return self.level_rows * self.level_cols

    @property
    def max_border_x(self) -> int:
        return self.w - EDGE_THRESHOLD

    @property
    def max_border_y(self) -> int:
        return self.h - EDGE_THRESHOLD

    @property
    def top_k(self) -> int:
        return min(self.cell_w * self.cell_h, max(self.n_desired, 1))

    @property
    def active(self) -> bool:
        return (
            self.n_desired > 0
            and self.level_cols >= 1
            and self.level_rows >= 1
            and self.max_border_x - EDGE_THRESHOLD >= 7
            and self.max_border_y - EDGE_THRESHOLD >= 7
        )


def make_layouts(cfg: ORBConfig, height: int, width: int) -> List[LevelLayout]:
    shapes = pyramid.pyramid_shapes(height, width, cfg.scale_factor, cfg.n_levels)
    budgets = cfg.features_per_level()
    ratio = float(width) / float(height)
    layouts = []
    for (h, w), nd in zip(shapes, budgets):
        nd = int(nd)
        level_cols = int(math.sqrt(nd / (5.0 * ratio))) if nd > 0 else 0
        level_rows = int(ratio * level_cols)
        W = (w - EDGE_THRESHOLD) - EDGE_THRESHOLD
        H = (h - EDGE_THRESHOLD) - EDGE_THRESHOLD
        cell_w = math.ceil(W / level_cols) if level_cols >= 1 else 0
        cell_h = math.ceil(H / level_rows) if level_rows >= 1 else 0
        layouts.append(
            LevelLayout(h, w, nd, level_cols, level_rows, cell_w, cell_h)
        )
    return layouts


def _cell_windows(lay: LevelLayout):
    """Static FAST cell windows (iniY, iniX, hY, hX) per cell, row-major
    (ORBextractor.cc:986-1020): origin minBorder-3, size cell+6, last
    row/col clipped to maxBorder+3."""
    iniY = EDGE_THRESHOLD + np.arange(lay.level_rows) * lay.cell_h - 3
    iniX = EDGE_THRESHOLD + np.arange(lay.level_cols) * lay.cell_w - 3
    hY = np.full(lay.level_rows, lay.cell_h + 6)
    hX = np.full(lay.level_cols, lay.cell_w + 6)
    hY[-1] = lay.max_border_y + 3 - iniY[-1]
    hX[-1] = lay.max_border_x + 3 - iniX[-1]
    yy, xx = np.meshgrid(np.arange(lay.level_rows), np.arange(lay.level_cols),
                         indexing="ij")
    return (iniY[yy.ravel()], iniX[xx.ravel()], hY[yy.ravel()], hX[xx.ravel()])


def _cell_window_table(lay: LevelLayout) -> np.ndarray:
    """(5, n_cells) int64: the corners y0, x0, y1, x1 of each cell window in
    the padded summed-area table, and the window's area."""
    iy, ix, hy, hx = _cell_windows(lay)
    return np.stack([iy, ix, iy + hy, ix + hx, hy * hx]).astype(np.int64)


def _cell_quality_weights(qual: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Mean cost per FAST window -> normalized quality in [0, 1]
    (ORBextractor.cc:946-985): qual = 2/(1 + mean_cost/255) - 1.

    qual: (B, h, w) uint8 cost; win: ``_cell_window_table`` on qual's
    device. Returns (B, n_cells) float32. The summed-area table, its
    corner sums and the mean round as jitted XLA:CPU rounds them
    (numerics.py): the level-0 table passes 2^24, where a scan in another
    order gives other values."""
    q = qual.to(torch.float32)
    sat = F.pad(numerics.xla_cumsum(numerics.xla_cumsum(q, 1), 2), (1, 0, 1, 0))
    y0, x0, y1, x1, area = win
    sums = sat[:, y1, x1] - sat[:, y0, x1] - sat[:, y1, x0] + sat[:, y0, x0]
    inv_area = 1.0 / area.to(torch.float32)    # XLA's division by a constant
    return numerics.quality(sums * inv_area, 255.0)


def _cell_quality_budgets(qual: torch.Tensor, win: torch.Tensor,
                          n_desired: int) -> torch.Tensor:
    """Per-cell budgets max(1, ceil(n_desired * w / sum(w))) of the cells'
    quality weights w (ORBextractor.cc:1058-1080): (B, n_cells) int32. The
    sum is taken in XLA's order: one ulp of it moves a budget whose
    quotient lies on an integer."""
    w = _cell_quality_weights(qual, win)
    b = torch.ceil(float(n_desired) * w / numerics.xla_sum(w)[:, None])
    return torch.clamp(b, min=1.0).to(torch.int32)


def _redistribute(n_total: torch.Tensor, budgets: torch.Tensor,
                  n_cells: int) -> torch.Tensor:
    """The reference's single budget-redistribution pass
    (ORBextractor.cc:1090-1132): row-major sequential scan where cells that
    cannot absorb their share push the deficit onto later cells.

    n_total, budgets: (R, n_cells) int — one independent scan per row (the
    JAX package vmaps a lax.scan over rows; here a loop over cells runs
    tensor ops over all rows). The share stays ceil(float32(d) / int)."""
    over = n_total > budgets
    retain0 = torch.where(over, budgets, n_total)
    d = torch.sum(torch.where(over, 0, budgets - n_total), dim=1)
    no_more0 = ~over
    n_no_more = torch.sum(no_more0.to(torch.int64), dim=1)
    run = (d > 0) & (n_no_more < n_cells)
    rets = []
    for i in range(n_total.shape[1]):
        tot, budget, no_more = n_total[:, i], budgets[:, i], no_more0[:, i]
        share = torch.ceil(d.to(torch.float32) / torch.clamp(n_cells - n_no_more, min=1))
        new_budget = budget + share.to(budget.dtype)
        can = tot > new_budget
        rets.append(torch.where(no_more, retain0[:, i],
                                torch.where(can, new_budget, tot)))
        stay = no_more | can
        d = torch.where(stay, d, d + new_budget - tot)
        n_no_more = n_no_more + (~stay).to(torch.int64)
    return torch.where(run[:, None], torch.stack(rets, dim=1), retain0)


def _level_score_tiles(score_min: torch.Tensor, lay: LevelLayout, ini_th: int):
    """Phase A of histogram selection for B images of one level: band mask
    + cell-local 3x3 NMS in image layout + the iniTh/minTh per-cell choice.

    score_min: (B, h, w) int16 FAST scores at minThFAST. Returns
    (t (B, rows, cellH, cols, cellW) int32 score tiles, n_total
    (B, n_cells) detected count per cell)."""
    B = score_min.shape[0]
    dev = score_min.device
    rows, cols = lay.level_rows, lay.level_cols
    ch, cw = lay.cell_h, lay.cell_w
    can_h, can_w = rows * ch, cols * cw
    pad_h = max(0, EDGE_THRESHOLD + can_h - lay.h)
    pad_w = max(0, EDGE_THRESHOLD + can_w - lay.w)
    s = F.pad(score_min, (0, pad_w, 0, pad_h))
    s = s[:, EDGE_THRESHOLD:EDGE_THRESHOLD + can_h,
          EDGE_THRESHOLD:EDGE_THRESHOLD + can_w]
    ys = torch.arange(can_h, device=dev)
    xs = torch.arange(can_w, device=dev)
    band = ((ys < lay.max_border_y - EDGE_THRESHOLD)[:, None]
            & (xs < lay.max_border_x - EDGE_THRESHOLD)[None, :])
    s = torch.where(band, s, 0).to(torch.int32)

    # 3x3 NMS whose neighbours across a cell border count as 0 — exactly
    # the zero padding each cell's own cv::FAST call sees there
    p = F.pad(s, (1, 1, 1, 1))
    top_e = ((ys % ch) == 0)[:, None]
    bot_e = ((ys % ch) == ch - 1)[:, None]
    left_e = ((xs % cw) == 0)[None, :]
    right_e = ((xs % cw) == cw - 1)[None, :]
    nmax = torch.zeros_like(s)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            n = p[:, 1 + dy:1 + dy + can_h, 1 + dx:1 + dx + can_w]
            edge = None
            for cond, e in ((dy == -1, top_e), (dy == 1, bot_e),
                            (dx == -1, left_e), (dx == 1, right_e)):
                if cond:
                    edge = e if edge is None else edge | e
            if edge is not None:
                n = torch.where(edge, 0, n)
            nmax = torch.maximum(nmax, n)
    t_min = torch.where(s > nmax, s, 0)
    t_ini = torch.where(t_min >= ini_th, t_min, 0)

    def cells(x):  # free reshape, no transpose
        return x.reshape(B, rows, ch, cols, cw)

    cnt_ini = (cells(t_ini) > 0).sum(dim=(2, 4))
    use_min = (cnt_ini <= 3)[:, :, None, :, None]  # ORBextractor.cc:1054-1059
    t = torch.where(use_min, cells(t_min), cells(t_ini))
    n_total = (t > 0).sum(dim=(2, 4)).reshape(B, -1).to(torch.int32)
    return t, n_total


def _bcast(v: torch.Tensor) -> torch.Tensor:
    """(B, rows, cols) per-cell value -> broadcastable over (B, rows, ch, cols, cw)."""
    return v[:, :, None, :, None]


def _select_from_tiles_hist(t: torch.Tensor, n_retain: torch.Tensor,
                            lay: LevelLayout):
    """Phase B of histogram selection for B images of one level: per-cell
    and per-level retain-best via threshold binary search on INTEGER
    scores, reproducing the top_k path's result including its index-order
    tie-breaking (the JAX package asserts the equivalence).

    t: (B, rows, cellH, cols, cellW) int32 NMS'd scores (0 = not detected);
    n_retain: (B, n_cells) per-cell budgets after redistribution.
    Returns (y, x, resp, valid), each (B, n_desired)."""
    B = t.shape[0]
    dev = t.device
    rows, cols = lay.level_rows, lay.level_cols
    ch, cw = lay.cell_h, lay.cell_w
    nd = lay.n_desired
    nr = n_retain.reshape(B, rows, cols)
    detected = t > 0

    def count_gt(th):
        return (t > _bcast(th)).sum(dim=(2, 4))

    # smallest threshold with count_gt <= n_retain (counts are monotone
    # non-increasing in the threshold; FAST scores are < 256)
    lo = torch.zeros((B, rows, cols), dtype=torch.int32, device=dev)
    hi = torch.full((B, rows, cols), 255, dtype=torch.int32, device=dev)
    for _ in range(8):
        mid = (lo + hi) // 2
        ok = count_gt(mid) <= nr
        hi = torch.where(ok, mid, hi)
        lo = torch.where(ok, lo, mid + 1)
    t_c = hi
    need = torch.clamp(nr - count_gt(t_c), min=0)

    # ties at the cell threshold kept in pixel (row-major) order
    is_tie = t == _bcast(t_c)
    row_c = torch.cumsum(is_tie.to(torch.int32), dim=4)
    row_pfx = torch.cumsum(row_c[..., -1], dim=2) - row_c[..., -1]
    rank = row_c + row_pfx[..., None]
    keep = (t > _bcast(t_c)) | (is_tie & (rank <= _bcast(need)))
    keep = keep & detected

    # per-level retain-best over the kept set, same construction per image
    def g_count_gt(th):
        return (keep & (t > th[:, None, None, None, None])).sum(dim=(1, 2, 3, 4))

    glo = torch.zeros(B, dtype=torch.int32, device=dev)
    ghi = torch.full((B,), 255, dtype=torch.int32, device=dev)
    for _ in range(8):
        mid = (glo + ghi) // 2
        ok = g_count_gt(mid) <= nd
        ghi = torch.where(ok, mid, ghi)
        glo = torch.where(ok, glo, mid + 1)
    s_star = ghi[:, None, None, None, None]
    fill = torch.clamp(nd - g_count_gt(ghi), min=0)

    # global ties ordered by (cell, pixel)
    is_gtie = keep & (t == s_star)
    m_c = is_gtie.sum(dim=(2, 4)).reshape(B, -1)
    pfx_c = (torch.cumsum(m_c, dim=1) - m_c).reshape(B, rows, cols)
    growc = torch.cumsum(is_gtie.to(torch.int32), dim=4)
    growpfx = torch.cumsum(growc[..., -1], dim=2) - growc[..., -1]
    grank = growc + growpfx[..., None] + _bcast(pfx_c)
    final = keep & ((t > s_star) | (is_gtie & (grank <= fill[:, None, None, None, None])))

    # compaction: position of the k-th kept pixel in canvas order, found by
    # a binary search over the inclusive prefix counts (searchsorted: the
    # first index whose count reaches k — the JAX package's loop of
    # halvings computes the same index)
    can_h, can_w = rows * ch, cols * cw
    flat_n = can_h * can_w
    kcum = torch.cumsum(final.reshape(B, flat_n).to(torch.int32), dim=1)
    total = kcum[:, -1]
    target = torch.arange(1, nd + 1, device=dev).expand(B, nd).contiguous()
    pos = torch.clamp(torch.searchsorted(kcum.to(torch.int64), target), max=flat_n - 1)
    valid = target <= total[:, None]
    yc = pos // can_w
    xc = pos % can_w
    resp_i = t.reshape(B, flat_n).gather(1, pos)
    # order by (response desc, cell asc, pixel-in-cell asc) — the top_k
    # path's tie order — with one n_desired-sized sort on unique keys
    cell = (yc // ch) * cols + (xc // cw)
    within = (yc % ch) * cw + (xc % cw)
    tie_idx = cell * (ch * cw) + within
    key = torch.where(valid, resp_i * (1 << 22) + ((1 << 22) - 1 - tie_idx), -1)
    okey, order = torch.topk(key, nd, dim=1, sorted=True)
    valid = okey >= 0
    yo = torch.where(valid, yc.gather(1, order), 0)
    xo = torch.where(valid, xc.gather(1, order), 0)
    y = (EDGE_THRESHOLD + yo).to(torch.int32)
    x = (EDGE_THRESHOLD + xo).to(torch.int32)
    resp = torch.where(valid, resp_i.gather(1, order).to(torch.float32),
                       float("-inf"))
    return y, x, resp, valid


def _top(x: torch.Tensor, k: int):
    """The k largest entries along the last axis, in descending order, the
    lower index first among equal values (``lax.top_k``'s order): a stable
    descending sort, never ``torch.topk``, whose ties are unordered."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _tile_values(v: torch.Tensor, lay: LevelLayout) -> torch.Tensor:
    """(B, h, w) per-pixel values -> (B, n_cells, cellH * cellW) in the
    cells' row-major order; pixels outside the level are zero."""
    B = v.shape[0]
    rows, cols, ch, cw = lay.level_rows, lay.level_cols, lay.cell_h, lay.cell_w
    can_h, can_w = rows * ch, cols * cw
    v = F.pad(v, (0, max(0, EDGE_THRESHOLD + can_w - lay.w),
                  0, max(0, EDGE_THRESHOLD + can_h - lay.h)))
    v = v[:, EDGE_THRESHOLD:EDGE_THRESHOLD + can_h, EDGE_THRESHOLD:EDGE_THRESHOLD + can_w]
    return v.reshape(B, rows, ch, cols, cw).permute(0, 1, 3, 2, 4).reshape(
        B, lay.n_cells, ch * cw)


def _select_from_tiles_topk(t: torch.Tensor, n_retain: torch.Tensor,
                            qnorm, lay: LevelLayout):
    """Top-k selection for B images of one level (the reference's
    ``_select_level_keypoints`` after its tile phase): per-cell retain-best
    of the n_retain best responses, then per-level retain-best to
    n_desired, each by ``_top``.

    t: (B, rows, cellH, cols, cellW) int32 NMS'd scores (0 = not detected);
    n_retain: (B, n_cells) per-cell budgets after redistribution; qnorm:
    (B, h, w) float32 per-pixel quality that scales the responses, or None.
    Returns (y, x, resp, valid), each (B, n_desired)."""
    B = t.shape[0]
    cols, ch, cw = lay.level_cols, lay.cell_h, lay.cell_w
    tiles = t.permute(0, 1, 3, 2, 4).reshape(B, lay.n_cells, ch * cw)
    resp = tiles.to(torch.float32)
    if qnorm is not None:
        resp = resp * _tile_values(qnorm, lay)
    flat = torch.where(tiles > 0, resp, float("-inf"))
    k = lay.top_k
    vals, idxs = _top(flat, k)
    ar = torch.arange(k, device=t.device)
    keep = (ar < torch.clamp(n_retain, max=k)[..., None]) & torch.isfinite(vals)
    gvals = torch.where(keep, vals, float("-inf")).reshape(B, -1)
    top_vals, top_slots = _top(gvals, lay.n_desired)
    valid = torch.isfinite(top_vals)
    cell = top_slots // k
    within = idxs.reshape(B, -1).gather(1, top_slots)
    y = EDGE_THRESHOLD + (cell // cols) * ch + within // cw
    x = EDGE_THRESHOLD + (cell % cols) * cw + within % cw
    y = torch.where(valid, y, EDGE_THRESHOLD).to(torch.int32)
    x = torch.where(valid, x, EDGE_THRESHOLD).to(torch.int32)
    return y, x, top_vals, valid


class OrbExtractor:
    """Extraction pipeline for a fixed image geometry + ORB config.

    Build once per (height, width, config). Runs on the device of the
    images it is given."""

    def __init__(self, cfg: ORBConfig, height: int, width: int):
        self.cfg = cfg
        self.height = height
        self.width = width
        self.layouts = make_layouts(cfg, height, width)
        self.shapes = [(l.h, l.w) for l in self.layouts]
        self.scale_factors = cfg.scale_factors()
        self.capacity = int(sum(l.n_desired for l in self.layouts))
        self.level_offsets = np.cumsum(
            [0] + [s[0] for s in self.shapes[:-1]]).astype(np.int64)
        self._consts: Dict[Tuple[torch.device, str], torch.Tensor] = {}

    def _const(self, dev, name: str, make) -> torch.Tensor:
        """A static table made by ``make()`` on the host, cached per device
        so the per-frame path uploads nothing (an upload from pageable
        memory would sync the stream)."""
        t = self._consts.get((dev, name))
        if t is None:
            t = self._consts[(dev, name)] = torch.as_tensor(make(), device=dev)
        return t

    def select(self, levels: List[torch.Tensor], qlevels=None):
        """Keypoint selection for B images: kernel 1's FAST scores of every
        active level (one launch) -> cell-local NMS and the iniTh/minTh
        choice per level; per-cell budgets (weighted by the quality levels
        `qlevels`, (B, h_l, w_l) uint8 costs, when given); one batched
        redistribution for all (level, image) rows; then per level the
        histogram path, or the top-k path when `qlevels` is given or
        ``select_path`` is "topk". Returns a list of (level, yx (B, n_l, 2)
        int32, resp, valid, xy0) per active level."""
        if self.cfg.select_path not in ("hist", "topk"):
            raise ValueError(f"select_path {self.cfg.select_path!r}")
        use_hist = qlevels is None and self.cfg.select_path == "hist"
        B = levels[0].shape[0]
        act = [lvl for lvl, lay in enumerate(self.layouts) if lay.active]
        scores = fast_score_levels(
            [levels[lvl].contiguous() for lvl in act], self.cfg.min_th_fast)
        stage_a = []
        for lvl, score_min in zip(act, scores):
            lay = self.layouts[lvl]
            t, n_tot = _level_score_tiles(score_min, lay, self.cfg.ini_th_fast)
            stage_a.append((lvl, lay, t, n_tot))
        active = [lay for _, lay, _, _ in stage_a]
        ncmax = max(lay.n_cells for lay in active)
        tot_rows = torch.cat([F.pad(n_tot, (0, ncmax - lay.n_cells))
                              for _, lay, _, n_tot in stage_a])
        dev = tot_rows.device
        qnorms = {}
        if qlevels is None:
            bud_rows = self._const(dev, f"budgets{B}", lambda: np.concatenate([
                np.tile(np.pad(
                    np.full(lay.n_cells, math.ceil(lay.n_desired / lay.n_cells), np.int32),
                    (0, ncmax - lay.n_cells)), (B, 1))
                for lay in active
            ]))
        else:
            # ORBextractor.cc:1058-1080: per-pixel quality scales the
            # responses; the cells' mean quality sets their budgets
            table = self._const(dev, "quality255", lambda: numerics.quality_table(255.0))
            buds = []
            for lvl, lay, _, _ in stage_a:
                q = qlevels[lvl]
                qnorms[lvl] = table[q.to(torch.int64)]
                win = self._const(dev, f"cells{lvl}", lambda lay=lay: _cell_window_table(lay))
                buds.append(F.pad(_cell_quality_budgets(q, win, lay.n_desired),
                                  (0, ncmax - lay.n_cells)))
            bud_rows = torch.cat(buds)
        ret_rows = _redistribute(tot_rows, bud_rows, ncmax)
        outs = []
        for i, (lvl, lay, t, _) in enumerate(stage_a):
            n_ret = ret_rows[i * B:(i + 1) * B, :lay.n_cells]
            if use_hist:
                y, x, resp, valid = _select_from_tiles_hist(t, n_ret, lay)
            else:
                y, x, resp, valid = _select_from_tiles_topk(t, n_ret, qnorms.get(lvl), lay)
            scale = float(np.float32(self.scale_factors[lvl]))
            xy0 = torch.stack([x, y], dim=-1).to(torch.float32) * scale
            outs.append((lvl, torch.stack([y, x], dim=-1), resp, valid, xy0))
        return outs

    def finish_inputs(self, levels: List[torch.Tensor], yx_level: torch.Tensor,
                      octave: torch.Tensor):
        """Inputs of kernel 2 for B images: the raw canvas (B, sum_h, w0),
        the flattened raw and blurred canvases (B * sum_h, w0) and the
        (B * N, 2) int32 canvas coordinates of each keypoint (its level's
        row offset plus b * sum_h for image b)."""
        canvas_raw, _ = flatten_pyramid(levels)
        canvas_blur, _ = flatten_pyramid(
            [image.gaussian_blur(l, 7, 2.0) for l in levels])
        B, sum_h, w0 = canvas_raw.shape
        offs = self._const(yx_level.device, "offsets", lambda: self.level_offsets)
        row = (yx_level[..., 0].to(torch.int64) + offs[octave.to(torch.int64)]
               + torch.arange(B, device=yx_level.device)[:, None] * sum_h)
        yx_flat = torch.stack([row, yx_level[..., 1].to(torch.int64)], dim=-1)
        return (canvas_raw, canvas_raw.reshape(B * sum_h, w0),
                canvas_blur.reshape(B * sum_h, w0),
                yx_flat.reshape(-1, 2).to(torch.int32).contiguous())

    def extract_from_pyramid_batched(self, levels, qlevels=None,
                                     return_canvas=False):
        """Batched extraction over B images at once (levels[l]: (B, h, w)).

        Selection runs per level; the finishing stage (IC orientation +
        rBRIEF, kernel 2) runs ONCE over the flattened pyramid canvas of
        all batch elements. Patches never cross level boundaries thanks to
        the 19 px EDGE_THRESHOLD margin.

        qlevels: None, or the levels of B uint8 cost maps (as `levels`)
        that weight the selection. return_canvas=True additionally returns
        the (B, sum_h, w0) raw canvas so stereo matching can reuse it."""
        B = levels[0].shape[0]
        outs = self.select(levels, qlevels)
        yx_level = torch.cat([o[1] for o in outs], dim=1)       # (B, N, 2)
        octave = torch.cat([torch.full(o[1].shape[:2], o[0], dtype=torch.int32,
                                       device=yx_level.device) for o in outs], dim=1)
        canvas_raw, flat_raw, flat_blur, yx_flat = self.finish_inputs(
            levels, yx_level, octave)
        ang, desc = orient_brief(flat_raw, flat_blur, yx_flat)
        N = yx_level.shape[1]
        kp = Keypoints(
            xy=torch.cat([o[4] for o in outs], dim=1),
            response=torch.cat([o[2] for o in outs], dim=1),
            octave=octave,
            angle=ang.reshape(B, N),
            desc=desc.reshape(B, N, 32),
            valid=torch.cat([o[3] for o in outs], dim=1),
            yx_level=yx_level,
        )
        if return_canvas:
            return kp, canvas_raw
        return kp
