"""Multi-process training-data generation (the sharded datagen fast path).

Port of ``iv_slam_tpu/parallel/datagen.py``. The reference generates the
FCN's training data inside the sequential SLAM loop (Tracking.cc:687-775 ->
EvaluateFeatures -> GenerateImageQualityHeatmapGP -> dataset_creator), one
session a process. With ground-truth poses, which datagen requires, the
previous-frame training modes are local to a frame pair: the reference
keypoint lives in the preceding frame and the scored quantity is the
normalized epipolar error under the GT relative pose. So every pair can
be scored on its own:

  frontend (pyramids, ORB x2, stereo)            per frame
  GT-guided projection matching prev -> cur      per pair
  normalized epipolar scoring (epipolar_scores)  per pair
  GP heatmap and variance mask (ops/gp.py)        per pair

The JAX package runs a batch of frames as one program sharded over a 'dp'
mesh, batches overlapping by one frame so every consecutive pair is
scored. Here the pairs of each batch are split over the ranks of a
``mesh.DataParallel`` group; a rank runs the frontend on the frames its
pairs need, one frame at a time, scores its pairs on its device, and rank
0 writes the results of all ranks, in pair order, in the reference's
dataset schema (dataset_creator.h:39-57) through ``DatasetCreator``.

Deviation, as in the JAX package: correspondences come from GT-guided
projection matching (ORBmatcher::SearchByProjection with the GT pose), not
from the tracker's map-point associations; ``introspection/datagen.py``
stays the reference-exact sequential mode.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..config import Config
from ..introspection import feature_evaluator as fe
from ..introspection.dataset_creator import DatasetCreator
from ..ops import gp
from ..ops import match as match_ops
from ..slam.frame import StereoFrontend
from .mesh import DataParallel


class ShardedDatagen:
    def __init__(self, cfg: Config, height: int, width: int,
                 dp: Optional[DataParallel] = None, out_path: Optional[str] = None,
                 score_cap: int = 512, device=None):
        self.cfg = cfg
        self.dp = dp or DataParallel(0, 1)
        self.frontend = StereoFrontend(cfg, height, width, device)
        self.device = self.frontend.device
        # every rank counts what is written; rank 0 writes
        self.writes = out_path is not None
        self.creator = DatasetCreator(out_path) if self.writes and self.dp.rank == 0 else None
        self.n_saved = 0
        self.score_cap = score_cap
        self.bny, self.bnx, self.out_h, self.out_w = gp.grid_shape(
            height, width, cfg.gp.bin_size, cfg.gp.bin_stride)
        dev = self.device
        cam = cfg.camera
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
        self._cam = dict(fx=f32(cam.fx), fy=f32(cam.fy), cx=f32(cam.cx), cy=f32(cam.cy),
                         bf=f32(cam.bf), b=f32(cam.baseline), w=f32(width), h=f32(height),
                         th=f32(7.0))
        self._sf = torch.as_tensor(np.asarray(cfg.orb.scale_factors(), np.float32), device=dev)
        self._K = torch.as_tensor(cam.K().astype(np.float32), device=dev)

    def _frame(self, left: np.ndarray, right: np.ndarray) -> dict:
        h = self.frontend.submit(left, right)
        return dict(xy=h.kl.xy, octave=h.kl.octave, angle=h.kl.angle, desc=h.kl.desc,
                    valid=h.kl.valid, u_right=h.u_right, depth=h.depth)

    def score_pair(self, cur: dict, prev: dict, Twc_cur: torch.Tensor,
                   Twc_prev: torch.Tensor) -> dict:
        """Score one (prev -> cur) pair of frontend outputs under their GT
        poses (device tensors) -> heatmap, mask, bad share, scored count,
        errors (-1 where not scored), the scored rows and their keypoints."""
        cfg, c = self.cfg, self._cam
        cam = cfg.camera
        # prev keypoints with stereo depth -> world points via the GT pose
        z = prev["depth"]
        has_d = prev["valid"] & (z > 0)
        xyp = prev["xy"]
        pc = torch.stack([(xyp[:, 0] - cam.cx) * z / cam.fx,
                          (xyp[:, 1] - cam.cy) * z / cam.fy, z], dim=1)
        Xw = pc @ Twc_prev[:3, :3].T + Twc_prev[:3, 3]
        Tcw_cur = torch.linalg.inv(Twc_cur)
        Tcw_prev = torch.linalg.inv(Twc_prev)
        assign, _n = match_ops.search_by_projection_last_frame(
            cur["xy"], cur["octave"], cur["angle"], cur["desc"], cur["u_right"], cur["valid"],
            Xw, prev["desc"], prev["octave"], prev["angle"], has_d, Tcw_cur, Tcw_prev,
            c["fx"], c["fy"], c["cx"], c["cy"], c["bf"], c["b"], c["w"], c["h"], self._sf,
            c["th"])
        # matched pairs, capped to score_cap in keypoint order (the
        # sequential path caps alike through cfg.gp.max_train_points)
        matched = assign >= 0
        order = torch.argsort((~matched).to(torch.int8), stable=True)  # matched first
        sel = order[:min(self.score_cap, assign.shape[0])]
        sel_ok = matched[sel]
        j = torch.clamp(assign[sel], min=0).long()
        kp_cur = cur["xy"][sel]
        kp_ref = xyp[j]
        sig2 = (self._sf ** 2)[cur["octave"][sel].long()]
        T_rel = Tcw_cur @ Twc_prev             # ref-cam -> cur-cam (GT)
        zeros = torch.zeros((3, 3), dtype=torch.float32, device=self.device)
        scores = fe.epipolar_scores(kp_ref, kp_cur, sig2, sel_ok, T_rel, self._K, zeros, zeros,
                                    torch.tensor(False, device=self.device))
        err = scores.norm_err
        ok = sel_ok & (err >= 0)
        err = torch.where(ok, err, -1.0)
        pct, cnt = fe.bad_match_stats(err, fe.BAD_ERR_THRESH)
        g = cfg.gp
        mean, var = gp.gp_grid_predict(torch.where(ok[:, None], kp_cur, 0.0),
                                       torch.where(ok, err, 0.0), ok, self.bny, self.bnx,
                                       g.bin_size, g.bin_stride, g.sigma_f, g.length_scale,
                                       g.sigma_n)
        return dict(heatmap=gp.heatmap_from_grid(mean, self.out_h, self.out_w),
                    mask=gp.mask_from_variance(var, self.out_h, self.out_w), pct=pct, cnt=cnt,
                    err=err, sel=sel, kp=kp_cur)

    def _pairs(self, frames, gt_poses, rows: List[int]) -> List[dict]:
        """Score pairs (rows[k] - 1 -> rows[k]) on this rank -> host dicts."""
        cache = {}

        def frame(i):
            if i not in cache:
                cache[i] = self._frame(*frames[i])
            return cache[i]

        pose = lambda i: torch.as_tensor(np.asarray(gt_poses[i], np.float32),  # noqa: E731
                                         device=self.device)
        out = []
        for i in rows:
            r = self.score_pair(frame(i), frame(i - 1), pose(i), pose(i - 1))
            out.append({k: v.cpu().numpy() for k, v in r.items()})
            cache.pop(i - 1, None)
        return out

    def process_session(self, frames: List, gt_poses: List[np.ndarray],
                        img_names: Optional[List[str]] = None,
                        batch: Optional[int] = None) -> dict:
        """Datagen over a whole session, in batches of `batch` frames that
        overlap by one frame (so every consecutive pair is scored once),
        the pairs of a batch split over the ranks. Returns summary stats on
        every rank; rank 0 writes the dataset when out_path was given (the
        good frames, n_good, count only then, as in the JAX package)."""
        b = batch or max(2 * self.dp.world, 8)
        names = img_names or [f"{i:06d}.png" for i in range(len(frames))]
        n_good = n_pairs = 0
        pcts = []
        start = 0
        while start + 1 < len(frames):
            stop = min(start + b, len(frames))
            cur_rows = list(range(start + 1, stop))
            mine = [cur_rows[k] for k in self.dp.items(len(cur_rows))]
            results = self._pairs(frames, gt_poses, mine)
            if self.dp.world > 1:
                import torch.distributed as dist

                parts = [None] * self.dp.world
                dist.all_gather_object(parts, results)
                results = [r for part in parts for r in part]
            for i_cur, r in zip(cur_rows, results):
                n_pairs += 1
                pcts.append(float(r["pct"]))
                good = self.writes and fe.frame_good_for_training(float(r["pct"]),
                                                                  int(r["cnt"]))
                n_good += good
                if self.creator is not None and good:
                    self.creator.save_bad_region_heatmap(names[i_cur], r["heatmap"])
                    self.creator.save_bad_region_heatmap_mask(names[i_cur], r["mask"])
                    ok = r["err"] >= 0
                    n = int(ok.sum())
                    self.creator.append_keypoints(r["kp"][ok], np.zeros(n, np.float32),
                                                  np.zeros(n, np.float32), r["err"][ok])
            start = stop - 1  # overlap one frame
        if self.creator is not None:
            self.creator.save_to_file()
        self.n_saved = n_good
        return dict(n_pairs=n_pairs, n_good=n_good,
                    mean_bad_pct=float(np.mean(pcts)) if pcts else float("nan"))
