"""Headless visualization (src/{Viewer,FrameDrawer,MapDrawer}.cc roles).

Port of ``iv_slam_tpu/slam/viewer.py``. The reference drives a Pangolin GL
window with headless + save-to-file modes (Viewer.cc:56-70, YAML
Viewer.HeadlessMode/SaveFramesToFile/SaveMapDrawingsToFile); this module
implements the save-to-file modes: current-frame keypoint/match overlays
(FrameDrawer) with quality coloring in training mode, and top-down map
renders with trajectory + GT overlay (MapDrawer,
map_drawer_visualize_gt_pose). It draws with ``io/raster.py`` (cv2's
primitives, every primitive of a frame in one scatter, the reference's
call order kept where they overlap) and writes PNGs with ``io/png.py``.
It reads the port's ``Frame`` after ``track_*`` returned and the host
``MapStore``; it writes to neither.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..io import raster
from ..io.png import write_png

GREY = (160, 160, 160)


def _save_bgr(path: str, img: np.ndarray) -> None:
    """cv2.imwrite of a BGR image as PNG (stored RGB, at cv2's default speed
    setting)."""
    write_png(path, np.ascontiguousarray(img[..., ::-1]), level=1)


class FrameDrawer:
    """Keypoint/match overlay images (src/FrameDrawer.cc)."""

    def __init__(self, out_dir: Optional[str] = None):
        self.out_dir = out_dir
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)

    def draw(self, img_gray: np.ndarray, frame, state_name: str = "OK"):
        """The overlay of `frame`'s valid keypoints: matched ones as an 11x11
        square and a dot in their quality colour (green good, red bad),
        the others as grey dots, in keypoint order; the state and match
        count at the bottom left."""
        vis = raster.gray2bgr(img_gray)
        idx = np.nonzero(frame.valid)[0]
        pts = np.rint(np.asarray(frame.xy, np.float64)[idx]).astype(np.int64)
        matched = np.asarray(frame.map_pt)[idx] >= 0
        q = np.maximum(np.asarray(frame.qual_score, np.float64)[idx], 0.0)
        colors = np.stack([np.zeros_like(q), np.trunc(255 * q), np.trunc(255 * (1 - q))], 1)
        colors = np.clip(colors, 0, 255).astype(np.int64)
        b = raster.Batch(vis.shape)
        m, u = matched, ~matched
        b.rectangles(pts[m] - 5, pts[m] + 5, colors[m], 1, keys=2 * idx[m])
        b.circles(pts[m], 2, colors[m], -1, keys=2 * idx[m] + 1)
        b.circles(pts[u], 1, [GREY], -1, keys=2 * idx[u])
        n_matched = int(m.sum())
        b.text(f"{state_name}  matches: {n_matched}", (10, vis.shape[0] - 10),
               raster.FONT_HERSHEY_PLAIN, 1.0, (255, 255, 255), 1,
               key=2 * len(frame.valid))
        b.paint(vis)
        if self.out_dir:
            _save_bgr(os.path.join(self.out_dir, f"frame_{frame.frame_id:06d}.png"), vis)
        return vis


def draw_heatmap_overlay(
    img_gray: np.ndarray,
    heatmap: np.ndarray,
    good_for_training: bool,
    keypoints_xy: Optional[np.ndarray] = None,
    errors: Optional[np.ndarray] = None,
    out_path: Optional[str] = None,
):
    """Training-data debug visualization (feature_evaluator.cpp:1057-1114):
    heatmap blended over the image, green/red dot for the good-for-training
    verdict, optional per-keypoint error coloring."""
    h, w = heatmap.shape
    base = raster.gray2bgr(img_gray[:h, :w])
    vis = raster.add_weighted(base, 0.5, raster.apply_colormap_jet(heatmap), 0.5, 0)
    b = raster.Batch(vis.shape)
    b.circles([(24, 24)], 12, [(0, 255, 0) if good_for_training else (0, 0, 255)], -1)
    if keypoints_xy is not None and errors is not None:
        errors = np.asarray(errors, np.float64)
        emax = max(float(np.max(errors)), 1e-6)
        keep = np.nonzero(errors >= 0)[0]
        c = np.trunc(255 * np.minimum(errors[keep] / emax, 1.0)).astype(np.int64)
        b.circles(np.trunc(np.asarray(keypoints_xy, np.float64)[keep]).astype(np.int64), 2,
                  np.stack([np.zeros_like(c), 255 - c, c], 1), -1, keys=1 + keep)
    b.paint(vis)
    if out_path:
        _save_bgr(out_path, vis)
    return vis


class MapDrawer:
    """Top-down map/trajectory renders (src/MapDrawer.cc). Optional GT
    trajectory overlay (gflag map_drawer_visualize_gt_pose)."""

    def __init__(self, out_dir: Optional[str] = None, size: int = 800):
        self.out_dir = out_dir
        self.size = size
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)

    def draw(self, map_store, trajectory_twc, gt_twc=None, frame_id=0,
             show_points=True, show_keyframes=True, show_graph=False,
             follow_camera=False, follow_extent=40.0):
        """Layer flags mirror the reference Viewer menu booleans
        (menuShowPoints/menuShowKeyFrames/menuShowGraph/menuFollowCamera,
        src/Viewer.cc:96-100 -> MapDrawer::DrawMapPoints/DrawKeyFrames).
        follow_camera centers a fixed `follow_extent`-meter window on the
        newest trajectory point instead of fitting the whole map."""
        size = self.size
        vis = np.full((size, size, 3), 20, np.uint8)
        n = map_store.n_points
        pts = map_store.pt_pos[:n][map_store.pt_alive[:n]]
        traj = np.array([T[:3, 3] for T in trajectory_twc]) if trajectory_twc \
            else np.zeros((0, 3))
        allxz = np.concatenate(
            [pts[:, [0, 2]], traj[:, [0, 2]]] if len(traj) else [pts[:, [0, 2]]]
        ) if len(pts) else traj[:, [0, 2]]
        if len(allxz) == 0:
            return vis
        if follow_camera and len(traj):
            center = traj[-1][[0, 2]]
            lo = center - follow_extent / 2.0
            hi = center + follow_extent / 2.0
        else:
            lo = allxz.min(axis=0) - 1
            hi = allxz.max(axis=0) + 1
        scale = (size - 40) / max(float((hi - lo).max()), 1e-6)

        def to_px(xz):
            p = (np.asarray(xz).reshape(-1, 2) - lo) * scale + 20
            px = np.trunc(p).astype(np.int64)
            return np.stack([px[:, 0], size - px[:, 1] - 1], 1)

        b = raster.Batch(vis.shape)
        if show_points and len(pts):
            b.circles(to_px(pts[:, [0, 2]]), 1, [(180, 180, 180)], -1)
        kf_ids = [k for k in range(map_store.n_keyframes) if map_store.kf_alive[k]]
        centers = {k: map_store.kf_camera_center(k) for k in kf_ids} \
            if (show_keyframes or show_graph) else {}
        if show_graph:
            # covisibility graph (weight >= 100), MapDrawer::DrawKeyFrames
            # bDrawGraph branch
            a, c = [], []
            for k in kf_ids:
                for nb, w in map_store.covisible_keyframes(k):
                    if nb > k and w >= 100 and nb in centers:
                        a.append(centers[k][[0, 2]])
                        c.append(centers[nb][[0, 2]])
            if a:
                b.lines(to_px(np.array(a)), to_px(np.array(c)), [(120, 200, 120)], 1)
        if show_keyframes and kf_ids:
            cpx = to_px(np.array([centers[k][[0, 2]] for k in kf_ids]))
            b.rectangles(cpx - 2, cpx + 2, [(255, 160, 0)], 1)
        if len(traj) > 1:
            t = to_px(traj[:, [0, 2]])
            b.lines(t[:-1], t[1:], [(0, 220, 0)], 1)
        if gt_twc is not None:
            gt = np.array([T[:3, 3] for T in gt_twc])
            if len(gt) > 1:
                g = to_px(gt[:, [0, 2]])
                b.lines(g[:-1], g[1:], [(0, 120, 255)], 1)
        b.paint(vis)
        if self.out_dir:
            _save_bgr(os.path.join(self.out_dir, f"map_{frame_id:06d}.png"), vis)
        return vis
