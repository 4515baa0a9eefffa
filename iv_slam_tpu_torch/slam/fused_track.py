"""The fused tracking step.

Port of ``iv_slam_tpu/slam/fused_track.py``. One step runs the whole
per-frame estimation chain against the device map mirror (device_map.py):

  motion-model projection search (narrow, and wide where the narrow window
  finds fewer than 20 matches) -> 4x10-round quality-weighted pose LM ->
  local search over ALL live map points (frustum + scale-window gated) ->
  pose LM again.

The step queues its work on the device with no host synchronisation: the
reference's data-dependent control flow becomes selections on the device
(both motion windows are searched and one kept with ``torch.where``; the LM
trials run as one batch, solvers/pose_opt.py), and every gather index is
clamped where ``jnp`` would clip it. The host reads one flat float32 pack
per frame, in the reference's layout (``tracking.py:808-858`` reads it).

``track`` takes the three host inputs (the last frame's map slots, the
predicted and the last pose) as one packed copy (utils/argpack.py);
``track_chained`` takes every input from the device: the previous step's
assignment map and pose chain, with the motion model applied on the
device, so chained tracking (slam/tracking.py) dispatches a frame with no
host upload and no sync.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import numerics
from ..geometry import camera
from ..ops import match as match_ops
from ..solvers import pose_opt
from ..utils import argpack
from ..utils.profiling import span
from . import resolve_device

LOCAL_CAP = 4096


class FusedResult(NamedTuple):
    T: torch.Tensor              # (4, 4) final pose
    assign_map: torch.Tensor     # (M,) device-map slot per keypoint or -1
    inlier: torch.Tensor         # (M,) bool (final pose-opt inliers)
    chi2: torch.Tensor           # (M,)
    n_motion: torch.Tensor       # () motion-model matches
    n_final: torch.Tensor        # () final inlier count


def pose_cap(n_kp: int) -> int:
    """Rows of the compacted pose-LM edge table: the frame's N keypoint
    slots hold ~500-1250 tracked matches, so the LM runs over a table of
    1024 rows, or 1536 at frame capacities above 1536."""
    return 1024 if n_kp <= 1536 else 1536


class FusedTracker:
    """The fused tracking step on one device. ``device`` defaults to CUDA;
    with no CUDA device the caller must pass ``device="cpu"`` (the tests'
    path)."""

    def __init__(self, cfg, height: int, width: int, device=None):
        self.device = dev = resolve_device(device, "FusedTracker")
        self.cfg = cfg
        self.height = height
        self.width = width
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
        cam = cfg.camera
        self.K = camera.Intrinsics.from_config(cam, dev)
        sf = cfg.orb.scale_factors()
        self.scale_factors = torch.as_tensor(sf, dtype=torch.float32, device=dev)
        self.inv_level_sigma2 = torch.as_tensor((1.0 / (sf * sf)).astype(np.float32),
                                                device=dev)
        self.log_scale = f32(np.log(cfg.orb.scale_factor))
        swm = cfg.matcher.search_window_multiplier
        self.baseline = f32(cam.baseline)
        self.img_w, self.img_h = f32(width), f32(height)
        self.th_narrow, self.th_wide = f32(7.0 * swm), f32(14.0 * swm)
        self.th_local = f32(1.0 * swm)
        self.nn_local = f32(0.8 * cfg.matcher.nn_ratio_multiplier)

    def _pose_opt(self, T0, slots, obs, inv_s2, cur_qual, map_pos, map_qual,
                  map_valid):
        """Pose LM over the keypoints with a map slot; over a compacted
        table of pose_cap(N) rows when the frame has more slots, with the
        results scattered back to the (N,) keypoint view by rank. Returns
        (PoseOptResult over N, overflow: edges beyond the table)."""
        cfg = self.cfg
        n_kp = slots.shape[0]
        cap = map_pos.shape[0]
        has = slots >= 0
        n_rounds = cfg.iv.optimizer_pose_opt_iter_count
        POSE_CAP = pose_cap(n_kp)
        if n_kp <= POSE_CAP:
            sl = torch.clamp(slots, 0, cap - 1)
            qual = map_qual[sl] if cfg.iv.propagate_keyptqual else cur_qual
            res = pose_opt.pose_optimization(
                T0, map_pos[sl], obs, inv_s2, qual, has & map_valid[sl], self.K,
                n_rounds=n_rounds)
            return res, torch.zeros((), dtype=torch.int32, device=slots.device)
        sel, sel_ok, cum = match_ops.compact(has, POSE_CAP)
        sl = torch.clamp(slots[sel], 0, cap - 1)
        qual = map_qual[sl] if cfg.iv.propagate_keyptqual else cur_qual[sel]
        res = pose_opt.pose_optimization(
            T0, map_pos[sl], obs[sel], inv_s2[sel], qual, sel_ok & map_valid[sl],
            self.K, n_rounds=n_rounds)
        # rank scatter-back to the (N,) keypoint view
        rank = torch.clamp(cum - 1, 0, POSE_CAP - 1)
        in_cap = has & ((cum - 1) < POSE_CAP)
        res = res._replace(inlier=in_cap & res.inlier[rank],
                           chi2=torch.where(in_cap, res.chi2[rank], 0.0))
        return res, torch.clamp(cum[-1] - POSE_CAP, min=0)

    def _step(
        self,
        # current frame (device tensors from the frontend)
        cur_xy, cur_oct, cur_angle, cur_desc, cur_ur, cur_valid, cur_qual,
        cur_depth,
        # last frame
        last_xy, last_oct, last_angle, last_valid,
        last_pt_ids,            # (N,) int32 map slots or -1
        T_pred, T_last,
        # device map tables
        map_pos, map_desc, map_normal, map_mind, map_maxd, map_qual, map_valid,
    ):
        """One tracking step. Returns (FusedResult, flat): flat is the
        (N * 10 + 20,) float32 host pack."""
        cam = self.cfg.camera
        K = self.K
        cap = map_pos.shape[0]
        # slots >= cap can only appear transiently after a map reset: clamp
        # the gather (jnp clips it) and gate them out
        ids = torch.clamp(last_pt_ids, 0, cap - 1)
        pt_pos = map_pos[ids]
        pt_desc = map_desc[ids]
        pt_ok = (map_valid[ids] & (last_pt_ids >= 0) & (last_pt_ids < cap)
                 & last_valid)

        def motion_search(th):
            with span("fused.motion_search"):
                return match_ops.search_by_projection_last_frame(
                    cur_xy, cur_oct, cur_angle, cur_desc, cur_ur, cur_valid,
                    pt_pos, pt_desc, last_oct, last_angle, pt_ok,
                    T_pred, T_last, K.fx, K.fy, K.cx, K.cy, K.bf, self.baseline,
                    self.img_w, self.img_h, self.scale_factors, th)

        # widen the window when matches are scarce (Tracking.cc:1333-1343):
        # both windows are searched, so the choice waits on no host read
        assign_n, n_n = motion_search(self.th_narrow)
        assign_w, n_w = motion_search(self.th_wide)
        widen = n_n < 20
        assign1 = torch.where(widen, assign_w, assign_n)
        n1 = torch.where(widen, n_w, n_n)
        # keypoint -> map slot from the motion stage
        slot1 = torch.where(assign1 >= 0, last_pt_ids[torch.clamp(assign1, min=0)], -1)

        obs_full = torch.cat([cur_xy, cur_ur[:, None]], dim=1)
        inv_s2_full = self.inv_level_sigma2[cur_oct]

        def run_pose_opt(T0, slots):
            with span("fused.pose_opt"):
                return self._pose_opt(T0, slots, obs_full, inv_s2_full, cur_qual,
                                      map_pos, map_qual, map_valid)

        res1, ovf1 = run_pose_opt(T_pred, slot1)
        slot1_in = torch.where(res1.inlier, slot1, -1)

        # local search: at live rungs above LOCAL_CAP, compact the map table
        # to the frustum-gated survivors first (the gate is the matcher's
        # own isInFrustum, so results are identical while the gated count
        # is <= LOCAL_CAP; the count ships in the host pack)
        with span("fused.local_search"):
            P = map_pos.shape[0]
            gate = match_ops.frustum_gate(
                map_pos, map_normal, map_mind, map_maxd, map_valid,
                res1.T, K.fx, K.fy, K.cx, K.cy, self.img_w, self.img_h)
            n_gate = gate.sum(dtype=torch.int32)
            tables = (map_pos, map_desc, map_normal, map_mind, map_maxd, map_valid)
            sel = None
            if P > LOCAL_CAP:
                sel, sel_ok, _ = match_ops.compact(gate, LOCAL_CAP)
                tables = tuple(t[sel] for t in tables)
                tables = tables[:-1] + (tables[-1] & sel_ok,)

            assign2, _ = match_ops.search_by_projection_local_map(
                cur_xy, cur_oct, cur_desc, cur_ur, cur_valid, slot1_in >= 0,
                *tables, res1.T, K.fx, K.fy, K.cx, K.cy, K.bf, self.img_w, self.img_h,
                self.scale_factors, self.log_scale, self.th_local, self.nn_local)
            if sel is not None:
                # map compacted-row indices back to full-table slots
                assign2 = torch.where(assign2 >= 0, sel[torch.clamp(assign2, min=0)], -1)
        merged = torch.where(slot1_in >= 0, slot1_in, assign2)
        res2, ovf2 = run_pose_opt(res1.T, merged)
        final_assign = torch.where(res2.inlier, merged, -1)
        res = FusedResult(T=res2.T, assign_map=final_assign, inlier=res2.inlier,
                          chi2=res2.chi2, n_motion=n1, n_final=res2.n_inliers)
        # every host-bound value as ONE flat float32 tensor: frame views,
        # tracking results, pose and counters (int values are exact in f32)
        f = torch.float32
        pack = torch.stack(
            [cur_xy[:, 0], cur_xy[:, 1], cur_oct.to(f), cur_valid.to(f),
             cur_ur, cur_depth, cur_qual, final_assign.to(f),
             res2.inlier.to(f), res2.chi2], dim=1)                 # (N, 10)
        small = torch.cat(
            [res2.T.reshape(16),
             torch.stack([n1.to(f), res2.n_inliers.to(f), n_gate.to(f),
                          torch.maximum(ovf1, ovf2).to(f)])])       # (20,)
        return res, torch.cat([pack.reshape(-1), small])

    def track(self, frame, last_frame, last_pt_ids, T_pred, dmap):
        """Returns (FusedResult, flat pack), both on the device.

        The frames' keypoints, u_right, depth and quality are the device
        tensors the frontend left on them; the three host inputs (last
        frame's map slots, the predicted and the last pose) ride one packed
        copy from pinned memory, without a host sync."""
        return argpack.call_packed(
            self._step,
            frame.kp.xy, frame.kp.octave, frame.kp.angle, frame.kp.desc,
            frame.ur_dev, frame.kp.valid, frame.qual_dev, frame.depth_dev,
            last_frame.kp.xy, last_frame.kp.octave, last_frame.kp.angle,
            last_frame.kp.valid, np.asarray(last_pt_ids, np.int32),
            np.asarray(T_pred, np.float32), np.asarray(last_frame.pose, np.float32),
            *dmap.live_views())

    def track_chained(self, frame, last_frame, last_assign_dev, T_dev, T_prev_dev, dmap):
        """The step for the frame after `last_frame` from the previous
        step's DEVICE results: its assignment map (the last frame's map
        slots) and the pose chain, T_pred = (T_i T_{i-1}^-1) T_i with
        T_i = T_dev, T_{i-1} = T_prev_dev, on the device. No host upload,
        no sync. The inverse is the reference's general one (LU, as
        jnp.linalg.inv) and it and the products go through numerics.py, so
        the card and the CPU path round alike."""
        T_pred = numerics.matmul(numerics.matmul(T_dev, numerics.inverse(T_prev_dev)), T_dev)
        return self._step(
            frame.kp.xy, frame.kp.octave, frame.kp.angle, frame.kp.desc,
            frame.ur_dev, frame.kp.valid, frame.qual_dev, frame.depth_dev,
            last_frame.kp.xy, last_frame.kp.octave, last_frame.kp.angle,
            last_frame.kp.valid, last_assign_dev, T_pred, T_dev, *dmap.live_views())
