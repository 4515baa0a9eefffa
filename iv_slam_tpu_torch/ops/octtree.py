"""Quadtree keypoint distribution (ComputeKeyPointsOctTree path).

Port of ``iv_slam_tpu/ops/octtree.py``: the reference's alternative
keypoint-selection path, the upstream ORB-SLAM2 quadtree NMS
(`DistributeOctTree`, ORBextractor.cc:545-769, and
`ComputeKeyPointsOctTree`, ORBextractor.cc:771-878). In the reference this
path is present but NOT active: the call site is commented out in favor of
`ComputeKeyPointsOld` (ORBextractor.cc:1247). It is offered as
`OrbExtractor.extract_octtree`.

Split: the dense work (FAST scoring over every pyramid level, kernel 1,
then orientation + BRIEF for the selected keypoints, kernel 2) runs on the
device; the quadtree itself, a data-dependent, pointer-chasing recursion
over at most a few thousand candidates a level, is host NumPy.

Reference quirks reproduced:
  * cell grid W=30 over the [EDGE_THRESHOLD-3, dim-EDGE_THRESHOLD+3) band,
    per-cell iniTh FAST falling back to minTh only when the cell is EMPTY
    (not the Old path's <=3 rule);
  * asymmetric cell-skip guards `iniY >= maxBorderY-3` / `iniX >= maxBorderX-6`
    (ORBextractor.cc:799-810);
  * the IV fork computes a per-cell quality score and stashes it in kp.size
    (ORBextractor.cc:825-838) but never uses it — retention is by FAST
    response and kp.size is overwritten with the scaled patch size right
    after (ORBextractor.cc:869-877). We therefore do not propagate it.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

EDGE_THRESHOLD = 19
_CELL_W = 30.0  # const float W = 30 (ORBextractor.cc:775)


class _Node:
    """One quadtree node: rectangle [x0, x1) x [y0, y1) + its keypoints."""

    __slots__ = ("x0", "y0", "x1", "y1", "idx", "no_more")

    def __init__(self, x0: int, y0: int, x1: int, y1: int, idx: np.ndarray):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.idx = idx
        self.no_more = idx.size == 1


def _divide(node: _Node, xs: np.ndarray, ys: np.ndarray) -> List[_Node]:
    """ExtractorNode::DivideNode (ORBextractor.cc:480-543): split at
    ceil-half extents; children in n1..n4 order, empty children dropped."""
    half_x = int(np.ceil((node.x1 - node.x0) / 2))
    half_y = int(np.ceil((node.y1 - node.y0) / 2))
    sx = node.x0 + half_x
    sy = node.y0 + half_y
    x, y = xs[node.idx], ys[node.idx]
    left = x < sx
    top = y < sy
    quads = (
        (node.x0, node.y0, sx, sy, left & top),        # n1
        (sx, node.y0, node.x1, sy, ~left & top),       # n2
        (node.x0, sy, sx, node.y1, left & ~top),       # n3
        (sx, sy, node.x1, node.y1, ~left & ~top),      # n4
    )
    return [
        _Node(x0, y0, x1, y1, node.idx[m])
        for (x0, y0, x1, y1, m) in quads
        if m.any()
    ]


def distribute_octtree(
    xs: np.ndarray,
    ys: np.ndarray,
    responses: np.ndarray,
    min_x: int,
    max_x: int,
    min_y: int,
    max_y: int,
    n: int,
) -> np.ndarray:
    """ORBextractor::DistributeOctTree (ORBextractor.cc:545-769).

    xs/ys are keypoint coords relative to (min_x, min_y); returns indices of
    the retained keypoints (the max-response point of each final node).
    Subdivides until the node count reaches `n` (or nodes are singletons),
    with the reference's two-phase schedule: full passes while a pass cannot
    overshoot, then a largest-first controlled expansion that stops within
    +2 of the target.
    """
    if xs.size == 0:
        return np.empty(0, dtype=np.int64)
    width = max_x - min_x
    height = max_y - min_y
    # C++ round() is half-away-from-zero; arguments are positive here
    n_ini = max(1, int(np.floor(width / height + 0.5)))
    h_x = width / n_ini

    # assignment is by int(kp.x / hX) (ORBextractor.cc:573-576) while node
    # bounds are the float coords truncated to Point2i — they can disagree
    # at bucket edges; both quirks reproduced
    bucket = np.clip((xs / h_x).astype(np.int64), 0, n_ini - 1)
    all_idx = np.arange(xs.size)
    nodes: List[_Node] = []
    for i in range(n_ini):
        x0 = int(h_x * i)
        x1 = int(h_x * (i + 1))
        nodes.append(_Node(x0, 0, x1, height, all_idx[bucket == i]))
    nodes = [nd for nd in nodes if nd.idx.size > 0]

    to_expand: List[_Node] = []
    while True:
        prev_size = len(nodes)
        nxt: List[_Node] = []
        to_expand = []
        for nd in nodes:
            if nd.no_more:
                nxt.append(nd)
                continue
            for child in _divide(nd, xs, ys):
                nxt.append(child)
                if child.idx.size > 1:
                    to_expand.append(child)
        nodes = nxt
        if len(nodes) >= n or len(nodes) == prev_size:
            break
        if len(nodes) + 3 * len(to_expand) > n:
            # controlled expansion: largest nodes first, stop at >= n
            # (ORBextractor.cc:687-745)
            finished = False
            while not finished:
                prev_size = len(nodes)
                pending = sorted(to_expand, key=lambda nd: nd.idx.size)
                to_expand = []
                for nd in reversed(pending):
                    nodes.remove(nd)
                    for child in _divide(nd, xs, ys):
                        nodes.append(child)
                        if child.idx.size > 1:
                            to_expand.append(child)
                    if len(nodes) >= n:
                        break
                if len(nodes) >= n or len(nodes) == prev_size:
                    finished = True
            break

    # retain the best (max-response) point of each node (ORBextractor.cc:748-768)
    return np.array(
        [nd.idx[np.argmax(responses[nd.idx])] for nd in nodes], dtype=np.int64
    )


def _cell_nms(sub: np.ndarray) -> np.ndarray:
    """3x3 strict non-max suppression inside one cell window, after zeroing
    the 3-px detection border (cv::FAST on the sub-image: no corners within
    3 px of the window edge, and only detected corners suppress)."""
    s = sub.astype(np.int32).copy()
    s[:3, :] = 0
    s[-3:, :] = 0
    s[:, :3] = 0
    s[:, -3:] = 0
    p = np.pad(s, 1)
    nmax = np.zeros_like(s)
    h, w = s.shape
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if dy == 1 and dx == 1:
                continue
            np.maximum(nmax, p[dy:dy + h, dx:dx + w], out=nmax)
    return np.where(s > nmax, s, 0)


def compute_keypoints_octtree(
    score_min: np.ndarray, ini_th: int, n_desired: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """ORBextractor::ComputeKeyPointsOctTree for one level
    (ORBextractor.cc:771-878), from a dense minTh FAST score map
    (`ops.fast.fast_score` convention: score-1, zero where not a corner).

    Returns (y, x, response) int32/int32/float32 arrays in full-level pixel
    coordinates. The iniTh pass reuses the minTh map: a corner's suppressor
    always has a strictly greater score, so NMS commutes with the threshold
    mask (same argument as ops/extractor.py's single-FAST-pass selection).
    """
    h, w = score_min.shape
    min_border = EDGE_THRESHOLD - 3
    max_border_x = w - EDGE_THRESHOLD + 3
    max_border_y = h - EDGE_THRESHOLD + 3
    width = float(max_border_x - min_border)
    height = float(max_border_y - min_border)
    n_cols = max(1, int(width / _CELL_W))
    n_rows = max(1, int(height / _CELL_W))
    w_cell = int(np.ceil(width / n_cols))
    h_cell = int(np.ceil(height / n_rows))

    ys_all: List[np.ndarray] = []
    xs_all: List[np.ndarray] = []
    rs_all: List[np.ndarray] = []
    for i in range(n_rows):
        ini_y = min_border + i * h_cell
        if ini_y >= max_border_y - 3:
            continue
        max_y = min(ini_y + h_cell + 6, max_border_y)
        for j in range(n_cols):
            ini_x = min_border + j * w_cell
            if ini_x >= max_border_x - 6:
                continue
            max_x = min(ini_x + w_cell + 6, max_border_x)
            nms = _cell_nms(score_min[ini_y:max_y, ini_x:max_x])
            ini_pass = np.where(nms >= ini_th, nms, 0)
            cell = ini_pass if (ini_pass > 0).any() else nms  # minTh fallback
            cy, cx = np.nonzero(cell)
            if cy.size == 0:
                continue
            # coords relative to the distribution band (kp += j*wCell etc.)
            ys_all.append(cy + (ini_y - min_border))
            xs_all.append(cx + (ini_x - min_border))
            rs_all.append(cell[cy, cx].astype(np.float32))

    if not ys_all:
        z = np.empty(0, dtype=np.int32)
        return z, z.copy(), np.empty(0, dtype=np.float32)
    ys = np.concatenate(ys_all)
    xs = np.concatenate(xs_all)
    rs = np.concatenate(rs_all)

    keep = distribute_octtree(
        xs, ys, rs,
        min_border, max_border_x, min_border, max_border_y, n_desired,
    )
    return (
        (ys[keep] + min_border).astype(np.int32),
        (xs[keep] + min_border).astype(np.int32),
        rs[keep],
    )
