"""ORB feature extraction pipeline (ComputeKeyPointsOld), histogram path.

Port of ``iv_slam_tpu/ops/extractor.py`` for its default selection path
(``ORBConfig.select_path == "hist"``, no quality map). Reproduces the
reference's active extraction path (ORBextractor.cc:880-1296):

  pyramid -> FAST on all levels (kernel 1, ops/fast_cuda.py) -> cell-local NMS
  and the iniTh/minTh per-cell choice -> one budget-redistribution pass ->
  per-cell and per-level retain-best by integer-threshold search -> IC
  orientation + 7x7/sigma2 Gaussian blur + rBRIEF over the flattened
  pyramid canvas (kernel 2, ops/finish_cuda.py) -> level-0 coordinates.

Everything is static-shaped: each level emits exactly
``features_per_level[l]`` slots with a validity mask, and no step reads a
device value on the host, so a frame's work is queued without a sync.
The left/right pair is an explicit batch dimension B.

Not ported in this slice (they raise NotImplementedError): the top_k and
quality-weighted selection (``_select_level_keypoints``,
``select_path="topk"``, a non-None ``qlevels``) and ``extract_octtree``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ORBConfig
from . import fast_cuda, finish_cuda, image, pyramid
from .stereo import flatten_pyramid

EDGE_THRESHOLD = 19

_TOPK_TODO = ("top_k / quality-weighted keypoint selection is not ported yet "
              "(ROADMAP A11); use select_path='hist' without a quality map")


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

    def __call__(self, img: torch.Tensor, quality=None) -> Keypoints:
        if quality is not None:
            raise NotImplementedError(_TOPK_TODO)
        levels = pyramid.build_pyramid(img, self.shapes)
        return self.extract_from_pyramid(levels)

    def extract_octtree(self, img) -> Keypoints:
        raise NotImplementedError(
            "quadtree extraction (extract_octtree) is not ported yet (ROADMAP A14)")

    def _const(self, dev, name: str, make) -> torch.Tensor:
        """A static table made by ``make()`` on the host, cached per device
        so the per-frame path uploads nothing (an upload from pageable
        memory would sync the stream)."""
        t = self._consts.get((dev, name))
        if t is None:
            t = self._consts[(dev, name)] = torch.as_tensor(make(), device=dev)
        return t

    def select(self, levels: List[torch.Tensor]):
        """Histogram keypoint selection for B images: kernel 1's FAST scores
        of every active level (one launch) -> phase A per level; one batched
        redistribution for all (level, image) rows; phase B per level.
        Returns a list of (level, yx (B, n_l, 2) int32, resp, valid, xy0)
        per active level."""
        if self.cfg.select_path != "hist":
            raise NotImplementedError(_TOPK_TODO)
        B = levels[0].shape[0]
        act = [lvl for lvl, lay in enumerate(self.layouts) if lay.active]
        scores = fast_cuda.fast_score_levels(
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
        bud_rows = self._const(tot_rows.device, f"budgets{B}", lambda: np.concatenate([
            np.tile(np.pad(
                np.full(lay.n_cells, math.ceil(lay.n_desired / lay.n_cells), np.int32),
                (0, ncmax - lay.n_cells)), (B, 1))
            for lay in active
        ]))
        ret_rows = _redistribute(tot_rows, bud_rows, ncmax)
        outs = []
        for i, (lvl, lay, t, _) in enumerate(stage_a):
            n_ret = ret_rows[i * B:(i + 1) * B, :lay.n_cells]
            y, x, resp, valid = _select_from_tiles_hist(t, n_ret, lay)
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

        return_canvas=True additionally returns the (B, sum_h, w0) raw
        canvas so stereo matching can reuse it."""
        if qlevels is not None:
            raise NotImplementedError(_TOPK_TODO)
        B = levels[0].shape[0]
        outs = self.select(levels)
        yx_level = torch.cat([o[1] for o in outs], dim=1)       # (B, N, 2)
        octave = torch.cat([torch.full(o[1].shape[:2], o[0], dtype=torch.int32,
                                       device=yx_level.device) for o in outs], dim=1)
        canvas_raw, flat_raw, flat_blur, yx_flat = self.finish_inputs(
            levels, yx_level, octave)
        ang, desc = finish_cuda.orient_brief(flat_raw, flat_blur, yx_flat)
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

    def extract_from_pyramid(self, levels, qlevels=None) -> Keypoints:
        """Extraction of one image from prebuilt pyramid levels (h_l, w_l):
        a B=1 view of the batched path."""
        if qlevels is not None:
            raise NotImplementedError(_TOPK_TODO)
        kb = self.extract_from_pyramid_batched([l[None] for l in levels])
        return Keypoints(*(a[0] for a in kb))
