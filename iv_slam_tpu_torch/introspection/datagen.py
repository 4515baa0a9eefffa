"""Training-data generation orchestrator (Tracking.cc:687-775 hooks).

Port of ``iv_slam_tpu/introspection/datagen.py``. After each tracked frame
(state OK, counter > 2) in training mode:

  supervised (IVSLAM.unsupervisedLearning = 0):
    score matched keypoints against their map point's reference-keyframe
    observation by normalized epipolar error (EvaluateFeatures ->
    EvaluateAgainstRefKeyFrameEpipolarNormalized, fe.cpp:2512-2752), GP-
    interpolate into a heatmap, save when IsFrameGoodForTraining;

  unsupervised (= 1):
    map the pose-LM chi2 logs into quality scores
    (Frame::ComputeKeyPtQualScores), gate frame reliability by GT relative-
    pose chi2 + minimum velocity (EvaluateTrackingAccuracy), emit heatmap +
    variance mask (GenerateUnsupImageQualityHeatmapGP).

The pairing of keypoints reads the host map; the scoring, the GP and the
heatmap run on ``device``, each a few batched calls read back once.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..ops import gp
from ..slam import resolve_device
from . import feature_evaluator as fe
from . import unsupervised as unsup
from .dataset_creator import DatasetCreator


class DataGenerator:
    def __init__(self, cfg: Config, map_store, out_path: Optional[str], device=None):
        self.cfg = cfg
        self.map = map_store
        self.device = resolve_device(device, "DataGenerator")
        self.creator = DatasetCreator(out_path) if out_path else None
        self.n_saved = 0
        # the most recent process_frame_* result (cleared when a frame is
        # skipped)
        self.last_result = None
        self._cap = cfg.gp.max_train_points
        # loaded per-frame relative-pose uncertainty (stereo_kitti.cc
        # load_rel_pose_uncertainty): (N, 2) table + img_name -> frame id
        self.rel_pose_unc: Optional[object] = None
        self.rel_pose_unc_ids: Optional[dict] = None

    def set_map(self, map_store):
        self.map = map_store

    def set_rel_pose_uncertainty(self, unc, name_to_id: dict):
        """SetRelativeCamPoseUncertainty (System.cc:779-784): per-frame
        (translational, rotational) uncertainty rows + image-name index."""
        self.rel_pose_unc = unc
        self.rel_pose_unc_ids = dict(name_to_id)

    def _up(self, a, dtype=np.float32) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype)))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _gp(self, pts, vals, valid, img_hw):
        """The GP's (mean, variance) grid on the device, and the output size."""
        g = self.cfg.gp
        bny, bnx, out_h, out_w = gp.grid_shape(img_hw[0], img_hw[1], g.bin_size, g.bin_stride)
        mean, var = gp.gp_grid_predict(
            self._up(pts), self._up(vals), self._up(valid, bool), bny, bnx,
            g.bin_size, g.bin_stride, g.sigma_f, g.length_scale, g.sigma_n)
        return mean, var, out_h, out_w

    # ------------------------------------------------------- supervised

    def process_frame_supervised(self, frame, img_hw, prev_frame=None) -> Optional[dict]:
        """Score + heatmap for one tracked frame with GT pose available.

        Dispatches on cfg.iv.training_mode over the reference's 9-way
        TrainingMode enum (EvaluateFeatures, fe.cpp:119-151): the
        reference keypoint comes from the previous frame, the map point's
        reference keyframe, or prev-with-ref-fallback; the error is
        reprojection (fe.cpp:2115-2266), raw epipolar (2268-2411), or
        uncertainty-normalized epipolar (2413-2752, the default)."""
        self.last_result = None
        if frame.gt_pose is None or frame.pose is None:
            return None
        spec = fe.TRAINING_MODES[self.cfg.iv.training_mode]
        if spec is None:
            # the reference LOG(FATAL)s on these two enum values
            raise NotImplementedError(
                f"training mode {self.cfg.iv.training_mode!r} is not "
                "implemented (matches the reference, fe.cpp:2151-2209)")
        ref_source, err_type = spec
        m = self.map
        idx = np.nonzero(frame.map_pt >= 0)[0]
        if len(idx) == 0:
            return None
        if ref_source in ("prev", "prev_and_ref"):
            if prev_frame is None or prev_frame.gt_pose is None:
                return None
            prev_idx_of = {int(p): j for j, p in enumerate(prev_frame.map_pt) if p >= 0}
        kp_cur, kp_ref, lvl_sig2, keep = [], [], [], []
        pt_w, T_ref_cw = [], []
        ref_gtd, ref_gt_pose = [], []   # per-keypoint GT-depth gate inputs
        sf2 = m.scale_factors ** 2
        for i in idx:
            pid = int(frame.map_pt[i])
            if not m.pt_alive[pid]:
                continue
            prev_feat = (prev_idx_of.get(pid)
                         if ref_source in ("prev", "prev_and_ref") else None)
            if ref_source == "prev" and prev_feat is None:
                continue
            if prev_feat is not None and ref_source != "ref":
                ref_xy = prev_frame.xy[prev_feat]
                ref_pose, ref_gt = prev_frame.pose, prev_frame.gt_pose
                gtd = (float(prev_frame.kp_gt_depth[prev_feat])
                       if prev_frame.kp_gt_depth is not None else -1.0)
            else:
                ref_kf = int(m.pt_ref_kf[pid])
                feat = m.pt_obs[pid].get(ref_kf)
                if feat is None or m.kf_gt_pose[ref_kf] is None:
                    continue
                rf = m.kf_frames[ref_kf]
                ref_xy = rf.xy[feat]
                ref_pose = m.kf_pose[ref_kf]
                ref_gt = m.kf_gt_pose[ref_kf]
                gtd = float(rf.kp_gt_depth[feat]) if rf.kp_gt_depth is not None else -1.0
            ref_gtd.append(gtd)
            ref_gt_pose.append(ref_gt)
            kp_cur.append(frame.xy[i])
            kp_ref.append(ref_xy)
            lvl_sig2.append(sf2[frame.octave[i]])
            keep.append(i)
            if err_type == "reproj":
                pt_w.append(m.pt_pos[pid])
                T_ref_cw.append(ref_pose)
        if len(keep) < 4:
            return None
        n = len(keep)
        cap = self._cap
        pad = max(cap - n, 0)
        k = min(n, cap)
        kp_cur_a = np.pad(np.stack(kp_cur)[:cap], ((0, pad), (0, 0)))
        kp_ref_a = np.pad(np.stack(kp_ref)[:cap], ((0, pad), (0, 0)))
        sig_a = np.pad(np.array(lvl_sig2, np.float32)[:cap], (0, pad), constant_values=1.0)
        valid = np.zeros(cap, bool)
        valid[:k] = True
        K = self._up(self.cfg.camera.K())

        vis_feet = vis_reproj = None
        if err_type == "reproj":
            # zero-padded transforms are fine: padded slots are masked by
            # `valid` and guarded against z = 0
            T_rel_pt = fe.relative_transform(self._up(frame.gt_pose),
                                             self._up(np.stack(ref_gt_pose)[:cap]))
            T_rel_pt = torch.cat([T_rel_pt, T_rel_pt.new_zeros((pad, 4, 4))])
            err, proj = fe.map_point_reprojection_errors(
                self._up(kp_cur_a), self._up(np.pad(np.stack(pt_w)[:cap], ((0, pad), (0, 0)))),
                self._up(np.pad(np.stack(T_ref_cw)[:cap], ((0, pad), (0, 0), (0, 0)))),
                T_rel_pt, self._up(valid, bool), K)
            out = torch.cat([err, proj.reshape(-1)]).cpu().numpy()
            norm_err, vis_reproj = out[:cap], out[cap:].reshape(cap, 2)
            thresh = fe.BAD_ERR_THRESH_REPROJ
        else:
            if ref_source == "prev":
                ref_name = prev_frame.img_name
            else:
                ref_kf0 = int(m.pt_ref_kf[int(frame.map_pt[keep[0]])])
                ref_name = m.kf_frames[ref_kf0].img_name
            # per-keypoint relative GT transform: each map point's own
            # reference keyframe (fe.cpp:2545-2560)
            Tcw_cur = np.linalg.inv(frame.gt_pose)
            ref_stack = np.stack(ref_gt_pose)[:cap].astype(np.float64)
            T_rel = np.matmul(Tcw_cur[None], ref_stack).astype(np.float32)
            T_rel = np.pad(T_rel, ((0, max(cap - len(ref_stack), 0)), (0, 0), (0, 0)))
            T_rel[len(ref_stack):, range(4), range(4)] = 1.0  # pad = identity
            # loaded relative-pose uncertainty -> per-pair covariance
            # (fe.cpp:1398-1407; disables the x4 no-cov normalization)
            sigma_w = sigma_t = np.zeros((3, 3))
            has_cov = False
            if self.rel_pose_unc is not None:
                ids = self.rel_pose_unc_ids
                cov = fe.rel_pose_cov_from_uncertainty(
                    self.rel_pose_unc, ids.get(ref_name, -1), ids.get(frame.img_name, -1))
                if cov is not None:
                    sigma_w, sigma_t = cov
                    has_cov = True
            # the epipolar line comes from the REFERENCE keypoint carried
            # through T_rel (ref->cur), the distance is measured at the
            # CURRENT keypoint (fe.cpp CalculateEpipolarErrorVec)
            scores = fe.epipolar_scores(
                self._up(kp_ref_a), self._up(kp_cur_a), self._up(sig_a), self._up(valid, bool),
                self._up(T_rel), K, self._up(sigma_w), self._up(sigma_t),
                torch.tensor(has_cov, device=self.device))
            err = scores.norm_err if err_type == "epipolar_normalized" else scores.raw_err
            out = torch.cat([err, scores.foot.reshape(-1)]).cpu().numpy()
            norm_err, vis_feet = out[:cap], out[cap:].reshape(cap, 2)
            thresh = fe.BAD_ERR_THRESH
        # GT-depth uncertainty gate (GetGTReprojection, fe.cpp:1256-1340 +
        # its `continue` at 2352-2358): backproject the ref keypoint with
        # its GT depth, carry by the GT relative transform; a landing depth
        # > 600 m marks the GT depth uncertain and the keypoint is skipped
        if any(g > 0 for g in ref_gtd):
            cam = self.cfg.camera
            Tcw_cur = np.linalg.inv(np.asarray(frame.gt_pose, np.float64))
            for j in range(k):
                g = ref_gtd[j]
                if g <= 0 or norm_err[j] < 0:
                    continue
                rxy = kp_ref_a[j]
                p_ref = np.array([(rxy[0] - cam.cx) * g / cam.fx,
                                  (rxy[1] - cam.cy) * g / cam.fy, g, 1.0])
                p_cur = (Tcw_cur @ np.asarray(ref_gt_pose[j], np.float64)) @ p_ref
                if p_cur[2] > 600.0:
                    norm_err[j] = -1.0
        sel = norm_err >= 0
        if sel.sum() < 4:
            return None
        pct, cnt = fe.bad_match_stats(torch.from_numpy(norm_err), thresh)
        pct, cnt = float(pct), int(cnt)
        good = fe.frame_good_for_training(pct, cnt)

        mean, _var, out_h, out_w = self._gp(np.where(sel[:, None], kp_cur_a, 0.0),
                                            np.where(sel, norm_err, 0.0), sel, img_hw)
        heatmap = gp.heatmap_from_grid(mean, out_h, out_w).cpu().numpy()
        result = dict(
            heatmap=heatmap, good=good, bad_percent=pct, n_scored=cnt, norm_err=norm_err,
            keep=np.array(keep),
            # debug-visualization inputs (SaveImagesToFile)
            vis_keypoints=kp_cur_a[:k], vis_errs=norm_err[:k],
            vis_feet=None if vis_feet is None else vis_feet[:k],
            vis_reproj=None if vis_reproj is None else vis_reproj[:k],
            vis_thresh=float(thresh),
        )
        if self.creator is not None and good:
            self.creator.save_bad_region_heatmap(frame.img_name, heatmap)
            kept = np.array(keep)[:k][sel[:k]]
            self.creator.append_keypoints(frame.xy[kept], np.zeros(len(kept), np.float32),
                                          np.zeros(len(kept), np.float32), norm_err[sel])
            self.creator.append_descriptors(frame.desc[kept], frame.desc[kept], frame.img_name)
            self.n_saved += 1
        self.last_result = result
        return result

    # ----------------------------------------------------- unsupervised

    def process_frame_unsupervised(self, frame, chi2, chi2_dof, found, reliable,
                                   img_hw) -> Optional[dict]:
        self.last_result = None
        qual, active = unsup.compute_keypt_qual_scores(chi2, chi2_dof, found)
        idx = np.nonzero(active)[0]
        if len(idx) < 4:
            return None
        errs = unsup.unsup_error_values(qual[idx])
        cap = self._cap
        n = min(len(idx), cap)
        pts = np.zeros((cap, 2), np.float32)
        vals = np.zeros(cap, np.float32)
        valid = np.zeros(cap, bool)
        pts[:n] = frame.xy[idx[:n]]
        vals[:n] = errs[:n]
        valid[:n] = True
        mean, var, out_h, out_w = self._gp(pts, vals, valid, img_hw)
        maps = torch.stack([gp.heatmap_from_grid(mean, out_h, out_w, 0.0, 1.0),
                            gp.mask_from_variance(var, out_h, out_w)]).cpu().numpy()
        heatmap, mask = maps[0], maps[1]
        good = reliable and mask.sum() > 0
        if self.creator is not None and good:
            self.creator.save_bad_region_heatmap(frame.img_name, heatmap)
            self.creator.save_bad_region_heatmap_mask(frame.img_name, mask)
            self.n_saved += 1
        self.last_result = dict(heatmap=heatmap, mask=mask, good=good, qual=qual)
        return self.last_result

    def finalize(self):
        if self.creator is not None:
            self.creator.save_to_file()
