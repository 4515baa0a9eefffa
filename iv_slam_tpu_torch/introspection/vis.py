"""Training-data debug visualizations (FeatureEvaluator::SaveImagesToFile,
feature_evaluator.cpp:1057-1185 — the debugging flow documented in the
reference README's "Bad Region Heatmap ... Not Generated" section).

Port of ``iv_slam_tpu/introspection/vis.py``, drawn with ``io/raster.py``
(cv2's primitives) and written with ``io/jpeg.py`` (cv2.imwrite's JPEG at
its default quality, 95). Writes, per saved frame, under <out>/:
  bad_region_heatmap_vis/<img>.jpg         JET heatmap 50/50-blended onto
                                           the image + green/red
                                           good-for-training dot
  bad_region_heatmap_masked_vis/<img>.jpg  same, masked by the variance
                                           mask (unsupervised mode)
  epipolar_err_vec/<img>.jpg               keypoint (red) -> epipolar foot
                                           (green) arrows + bad-match %
  reprojection_err_vec/<img>.jpg           map-point projection (red) ->
                                           keypoint (green) arrows, bad
                                           keypoints only
Enabled by the drivers' --logging_level >= 1 (the reference's
iLoggingLevel gate, Tracking.cc:722-726). Its inputs are
``introspection/datagen.py``'s ``DataGenerator.last_result``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..io import jpeg, raster

GOOD = (0, 255, 0)   # BGR green (fe.cpp:1110-1114)
BAD = (0, 0, 255)    # red
BLUE = (255, 0, 0)
MAGENTA = (255, 0, 255)


def _pts(a) -> np.ndarray:
    """cv2 points from float coordinates: int() truncates toward zero."""
    return np.trunc(np.asarray(a, np.float64)).astype(np.int64).reshape(-1, 2)


def overlay_heatmap_on_image(
    img_gray: np.ndarray,
    heatmap_u8: np.ndarray,
    mask: Optional[np.ndarray] = None,
    good: Optional[bool] = None,
) -> np.ndarray:
    """OverlayHeatmapOnImage (fe.cpp:3194-3212): JET colormap, 0.5/0.5
    addWeighted onto the image cropped to the heatmap size; optional mask
    (fe.cpp:1143-1156) and the good-for-training flag circle at (480, 20)
    r=15 (fe.cpp:1126-1139; clipped into frame for small images)."""
    h, w = heatmap_u8.shape[:2]
    colored = raster.apply_colormap_jet(heatmap_u8)
    bg = raster.gray2bgr(img_gray)[:h, :w]
    merged = raster.add_weighted(bg, 0.5, colored, 0.5, 0.0)
    if mask is not None:
        merged = np.where(np.asarray(mask, bool)[:h, :w, None], merged, 0).astype(np.uint8)
    merged = np.ascontiguousarray(merged)
    if good is not None:
        cx, cy = min(480, w - 20), min(20, h - 20)
        raster.circle(merged, (cx, cy), 15, GOOD if good else BAD, -1)
    return merged


def draw_epipolar_err_vec(
    img_gray: np.ndarray,
    keypoints: np.ndarray,      # (N, 2) current-frame keypoints
    feet: np.ndarray,           # (N, 2) epipolar perpendicular feet
    errs: np.ndarray,           # (N,) normalized errors; < 0 skipped
    gt_reproj: Optional[np.ndarray] = None,
    bad_percent: Optional[float] = None,
) -> np.ndarray:
    """DrawEpipolarErrVec (fe.cpp:850-1050): red keypoint + green foot
    circles (r=5), blue arrow, optional magenta GT reprojection, bad-match
    percentage text. Drawn in the reference's order, keypoint by keypoint."""
    img = raster.gray2bgr(img_gray)
    b = raster.Batch(img.shape)
    idx = np.nonzero(np.asarray(errs) >= 0)[0]
    if len(idx):
        p, q = _pts(np.asarray(keypoints)[idx]), _pts(np.asarray(feet)[idx])
        b.circles(p, 5, [BAD], -1, keys=4 * idx)
        b.circles(q, 5, [GOOD], -1, keys=4 * idx + 1)
        b.arrowed_lines(p, q, [BLUE], 2, keys=4 * idx + 2)
        if gt_reproj is not None:
            gt = np.asarray(gt_reproj)[idx]
            on = gt[:, 0] >= 0
            b.circles(_pts(gt[on]), 5, [MAGENTA], -1, keys=4 * idx[on] + 3)
    if bad_percent is not None:
        b.text(f"bad: {bad_percent:.1f}%", (10, 25), raster.FONT_HERSHEY_SIMPLEX, 0.7,
               (255, 255, 255), 2, key=4 * len(np.asarray(errs)))
    return b.paint(img)


def draw_reprojection_err_vec(
    img_gray: np.ndarray,
    reproj: np.ndarray,         # (N, 2) map-point projections
    keypoints: np.ndarray,      # (N, 2) observed keypoints
    errs: np.ndarray,           # (N,) errors
    thresh: float,
) -> np.ndarray:
    """DrawReprojectionErrVec (fe.cpp:816-848): bad keypoints only
    (draw_only_bad_keypts), r=3 red projection + green keypoint + arrow."""
    img = raster.gray2bgr(img_gray)
    b = raster.Batch(img.shape)
    idx = np.nonzero(np.asarray(errs) > thresh)[0]   # draws only err > thresh
    if len(idx):
        p, q = _pts(np.asarray(reproj)[idx]), _pts(np.asarray(keypoints)[idx])
        b.circles(p, 3, [BAD], -1, keys=3 * idx)
        b.circles(q, 3, [GOOD], -1, keys=3 * idx + 1)
        b.arrowed_lines(p, q, [BLUE], 1, keys=3 * idx + 2)
    return b.paint(img)


class FeatureEvalVisualizer:
    """Directory layout + save orchestration of SaveImagesToFile."""

    DIRS = ("bad_region_heatmap_vis", "bad_region_heatmap_masked_vis",
            "epipolar_err_vec", "reprojection_err_vec")

    def __init__(self, out_path: str):
        self.out = out_path
        for d in self.DIRS:
            os.makedirs(os.path.join(out_path, d), exist_ok=True)

    def _write(self, subdir: str, img_name: str, img: np.ndarray):
        base = os.path.splitext(os.path.basename(img_name))[0]
        jpeg.write_jpeg(os.path.join(self.out, subdir, base + ".jpg"), img)

    def save_frame(self, img_gray, img_name: str, result: dict):
        """result: a DataGenerator.process_frame_* dict (heatmap, good,
        optional mask / keypoints / feet / errors / reproj)."""
        hm = result.get("heatmap")
        good = result.get("good")
        if hm is not None:
            self._write("bad_region_heatmap_vis", img_name,
                        overlay_heatmap_on_image(img_gray, hm, good=good))
            if result.get("mask") is not None:
                self._write("bad_region_heatmap_masked_vis", img_name,
                            overlay_heatmap_on_image(img_gray, hm, mask=result["mask"],
                                                     good=good))
        kp = result.get("vis_keypoints")
        if kp is not None and result.get("vis_feet") is not None:
            self._write("epipolar_err_vec", img_name,
                        draw_epipolar_err_vec(img_gray, kp, result["vis_feet"],
                                              result["vis_errs"],
                                              gt_reproj=result.get("vis_gt_reproj"),
                                              bad_percent=result.get("bad_percent")))
        if kp is not None and result.get("vis_reproj") is not None:
            self._write("reprojection_err_vec", img_name,
                        draw_reprojection_err_vec(img_gray, result["vis_reproj"], kp,
                                                  result["vis_errs"],
                                                  result.get("vis_thresh", 1.0)))
