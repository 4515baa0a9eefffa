"""Loop detection + correction (src/LoopClosing.cc, inline variant).

Port of ``iv_slam_tpu/slam/loop_closing.py``. Per new keyframe
(LoopClosing::Run, 57-106):

  detect_loop (108): BoW candidates above the covisible min-score, gated by
      3 temporally consistent candidate groups;
  compute_sim3 (236): BoW matches -> Sim3 RANSAC -> Sim3 window search ->
      Sim3 refinement over the union; accept at >= 40 refined inliers;
  correct_loop (407): propagate the corrected Sim3 through the covisible
      neighbourhood, move their map points, fuse the loop side's points
      into it, optimize the essential graph, then a global BA whose merge
      is deferred to tracking's next per-frame poll or keyframe event
      (``collect_gba``).

It runs inline after local mapping, as the reference's single-threaded
configuration does. Device work (BoW matching, the Sim3 solvers, the fuse
search, the essential graph, the global BA) runs on ``device``; the host
bookkeeping is numpy and Python, in the reference's dict and set order.

The Sim3 RANSAC's hypotheses come from ``self.sampler`` (default
``sim3_solver.sample_sim3``), called as sampler(kf_id, n_hyp, n_valid,
device): the reference draws them with ``jax.random`` under
PRNGKey(kf_id), which torch cannot reproduce.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..ops import bow_match
from ..ops import match as match_ops
from ..solvers import essential_graph as eg
from ..solvers import sim3_opt, sim3_solver
from ..solvers.local_ba import apply_global_ba, global_bundle_adjustment_async
from ..utils import argpack
from ..utils.profiling import span
from .keyframe_db import KeyFrameBow, KeyFrameDatabase
from .vocabulary import Vocabulary, l1_score

COVISIBILITY_CONSISTENCY_TH = 3


class LoopClosing:
    def __init__(self, cfg: Config, map_store, voc: Vocabulary, kfdb: KeyFrameDatabase,
                 device, bow: Optional[KeyFrameBow] = None):
        self.cfg = cfg
        self.map = map_store
        self.voc = voc
        self.kfdb = kfdb
        self.device = torch.device(device)
        self.bow = bow if bow is not None else KeyFrameBow(voc, map_store, self.device)
        self.last_loop_kf = -1
        self.consistent_groups: List[Tuple[set, int]] = []
        self.n_loops_closed = 0
        # optional recorder of its stages (utils/profiling.py): None, the installed one
        self.stage_timer = None
        # persistent loop-closure edges (KeyFrame::GetLoopEdges): past
        # closures stay as normal edges in later essential graphs
        self.loop_edges: set = set()
        # deferred global BA (the reference's GBA thread): solved at
        # CorrectLoop, merged at tracking's next poll or keyframe event
        self.pending_gba = None
        self.async_gba = bool(getattr(cfg.system, "async_gba", True))
        self.sampler = sim3_solver.sample_sim3

    # ------------------------------------------------------------- helpers

    def _up(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a)).to(self.device)

    # ----------------------------------------------------------- main loop

    def process_keyframe(self, kf_id: int, fix_scale: bool = True) -> bool:
        """Returns True if a loop was detected and corrected."""
        with span("lc_bow", kf=kf_id, timer=self.stage_timer):
            self.bow.ensure(kf_id)
            self.kfdb.add(kf_id, self.bow.kf_bow[kf_id])
        if self.map.n_keyframes < 11 or kf_id < self.last_loop_kf + 10:
            return False
        with span("lc_detect", kf=kf_id, timer=self.stage_timer):
            candidates = self._detect_loop(kf_id)
        if not candidates:
            return False
        with span("lc_sim3", kf=kf_id, timer=self.stage_timer):
            match = self._compute_sim3(kf_id, candidates, fix_scale)
        if match is None:
            return False
        loop_kf, S_corr, matched = match
        with span("lc_correct", kf=kf_id, timer=self.stage_timer):
            self._correct_loop(kf_id, loop_kf, S_corr, matched, fix_scale=fix_scale)
        self.last_loop_kf = kf_id
        self.n_loops_closed += 1
        return True

    # ------------------------------------------------------------- detect

    def _detect_loop(self, kf_id: int) -> List[int]:
        bow = self.bow.kf_bow[kf_id]
        connected = {k for k, _ in self.map.covisible_keyframes(kf_id)}
        min_score = 1.0
        for nb in connected:
            self.bow.ensure(nb)
            min_score = min(min_score, l1_score(bow, self.bow.kf_bow[nb]))
        cands = self.kfdb.detect_loop_candidates(kf_id, bow, min_score, connected, self.map)
        if not cands:
            self.consistent_groups = []
            return []
        # temporal consistency over 3 detections (LoopClosing.cc:161-225)
        enough: List[int] = []
        new_groups: List[Tuple[set, int]] = []
        for cand in cands:
            group = {cand} | {k for k, _ in self.map.covisible_keyframes(cand)}
            consistent_for = 0
            for prev_group, prev_count in self.consistent_groups:
                if group & prev_group:
                    consistent_for = max(consistent_for, prev_count + 1)
            new_groups.append((group, consistent_for))
            if consistent_for >= COVISIBILITY_CONSISTENCY_TH:
                enough.append(cand)
        self.consistent_groups = new_groups
        return enough

    # -------------------------------------------------------- compute sim3

    def _compute_sim3(self, kf_id: int, candidates: List[int], fix_scale: bool):
        m = self.map
        cur = m.kf_frames[kf_id]
        cam = self.cfg.camera
        up = self._up
        f32 = np.float32
        sf2 = m.scale_factors ** 2
        for cand in candidates:
            self.bow.ensure(cand)
            cf = m.kf_frames[cand]
            cur_has = cur.map_pt >= 0
            cand_has = cf.map_pt >= 0
            assign, n = bow_match.search_by_bow(
                cf.kp.desc, up(self.bow.kf_nodes[cand]), cf.kp.angle, up(cand_has & cf.valid),
                cur.kp.desc, up(self.bow.kf_nodes[kf_id]), cur.kp.angle, up(cur_has & cur.valid),
                torch.tensor(0.75, device=self.device))
            assign = torch.cat([assign, n[None]]).cpu().numpy()
            assign, n = assign[:-1], int(assign[-1])
            if n < 20:
                continue
            ai = np.nonzero(assign >= 0)[0]
            bi = assign[ai]
            # matched map point positions in each camera frame
            Tc_cand = m.kf_pose[cand]
            Tc_cur = m.kf_pose[kf_id]
            P1 = m.pt_pos[cf.map_pt[ai]] @ Tc_cand[:3, :3].T + Tc_cand[:3, 3]
            P2 = m.pt_pos[cur.map_pt[bi]] @ Tc_cur[:3, :3].T + Tc_cur[:3, 3]
            mm = len(ai)
            # the solvers see the m matches padded to the frame capacity
            N = cur.map_pt.shape[0]

            def _pad(a, n_real, tail=()):
                out = np.zeros((N,) + tail, f32)
                out[:n_real] = a
                return out

            sig_max = np.ones(N, f32)
            sig_max[:mm] = np.maximum(sf2[cf.octave[ai]], sf2[cur.octave[bi]])
            validp = np.zeros(N, bool)
            validp[:mm] = True
            # hypothesis triples from the real-match prefix [0, m) only
            # (Sim3Solver samples mvAllIndices, the actual matches)
            idx = self.sampler(kf_id, 256, mm, self.device)
            res = sim3_solver.sim3_ransac(
                up(_pad(P1, mm, (3,))), up(_pad(P2, mm, (3,))),
                up(_pad(cf.xy[ai], mm, (2,))), up(_pad(cur.xy[bi], mm, (2,))),
                up(sig_max), up(validp), cam.fx, cam.fy, cam.cx, cam.cy, idx,
                fix_scale=fix_scale)
            small = torch.cat([res.R.reshape(-1), res.t, res.s[None],
                               res.n_inliers[None].to(torch.float32)]).cpu().numpy()
            R_h, t_h, s_h, n_inl = small[:9].reshape(3, 3), small[9:12], small[12], int(small[13])
            if n_inl < 20:
                continue
            # extend the matches through the Sim3 window search
            # (ORBmatcher::SearchBySim3, LoopClosing.cc:236-404)
            sR = R_h * s_h
            cand_free = cand_has & cf.valid
            cur_free = cur_has & cur.valid
            P1_all = m.pt_pos[np.maximum(cf.map_pt, 0)] @ Tc_cand[:3, :3].T + Tc_cand[:3, 3]
            P2_all = m.pt_pos[np.maximum(cur.map_pt, 0)] @ Tc_cur[:3, :3].T + Tc_cur[:3, 3]
            f = lambda v: torch.tensor(v, dtype=torch.float32, device=self.device)  # noqa: E731
            ext, n_ext = bow_match.search_by_sim3(
                up(P1_all.astype(f32)), cf.kp.desc, up(cf.xy), up(cf.octave), up(cand_free),
                up(P2_all.astype(f32)), cur.kp.desc, up(cur.xy), up(cur.octave), up(cur_free),
                up(sR.astype(f32)), up(t_h.astype(f32)),
                f(cam.fx), f(cam.fy), f(cam.cx), f(cam.cy),
                up(m.scale_factors.astype(f32)),
                f(np.log(m.scale_factors[1] / m.scale_factors[0])),
                up(m.pt_max_dist[np.maximum(cf.map_pt, 0)].astype(f32)),
                up(m.pt_max_dist[np.maximum(cur.map_pt, 0)].astype(f32)))
            ext = torch.cat([ext, n_ext[None]]).cpu().numpy()
            ext, n_ext = ext[:-1], int(ext[-1])
            if n_ext + n_inl < 40:
                continue
            # union match set: BoW pairs + the Sim3 window extension
            # (LoopClosing.cc:345-360), deduplicated by candidate feature
            in_bow = np.zeros(N, bool)
            in_bow[ai] = True
            ext_ai = np.nonzero((ext >= 0) & ~in_bow)[0]
            af = np.concatenate([ai, ext_ai])
            bf = np.concatenate([bi, ext[ext_ai]])
            mu = len(af)
            inv1u = np.ones(N, f32)
            inv1u[:mu] = 1.0 / sf2[cf.octave[af]]
            inv2u = np.ones(N, f32)
            inv2u[:mu] = 1.0 / sf2[cur.octave[bf]]
            validu = np.zeros(N, bool)
            validu[:mu] = True
            # refine S: cand -> cur over the union set (Optimizer.cc:2018)
            opt = sim3_opt.optimize_sim3(
                res.R, res.t, res.s,
                up(_pad(P2_all[bf].astype(f32), mu, (3,))),
                up(_pad(P1_all[af].astype(f32), mu, (3,))),
                up(_pad(cur.xy[bf], mu, (2,))), up(_pad(cf.xy[af], mu, (2,))),
                up(inv2u), up(inv1u), up(validu), cam.fx, cam.fy, cam.cx, cam.cy,
                fix_scale=fix_scale)
            out = torch.cat([opt.R.reshape(-1), opt.t, opt.s.reshape(1),
                             opt.inliers.to(torch.float32)]).cpu().numpy()
            R_o, t_o, s_o = out[:9].reshape(3, 3), out[9:12], float(out[12])
            # acceptance: >= 40 post-refine inliers (the reference's
            # stricter combination of its >= 20 and >= 40 gates)
            opt_inl = out[13:][:mu] != 0.0
            if int(opt_inl.sum()) < 40:
                continue
            # corrected current pose: S_cur_w = S_cand->cur o T_cand_w
            S_rel = np.eye(4, dtype=f32)
            S_rel[:3, :3] = R_o * s_o
            S_rel[:3, 3] = t_o
            # the verified loop matches (mvpCurrentMatchedPoints),
            # restricted to the refine's surviving inliers
            matched: Dict[int, int] = {}
            for k_i in np.nonzero(opt_inl)[0]:
                pid = int(cf.map_pt[af[k_i]])
                cur_feat = int(bf[k_i])
                if cur_feat not in matched and pid >= 0 and m.pt_alive[pid]:
                    matched[cur_feat] = pid
            return cand, (S_rel, s_o), matched
        return None

    # ------------------------------------------------------------- correct

    def _propagate_correction(self, kf_id: int, loop_kf: int, S_corr, fix_scale: bool = True):
        """Correct the current KF's covisible neighbourhood and their points
        (LoopClosing.cc:438-521). Returns (corrected ids, pre-correction
        poses, corrected Sim3 per KF, point -> correcting KF)."""
        S_rel, scale = S_corr
        m = self.map
        T_cur_old = m.kf_pose[kf_id].astype(np.float64)
        T_cand = m.kf_pose[loop_kf]
        # corrected current pose as a Sim3 4x4 [sR|t] (mg2oScw = g2oSrel *
        # Scand_w, LoopClosing.cc:310-318)
        S_cur_new = np.vstack([S_rel[:3], [0, 0, 0, 1]]).astype(np.float64) @ T_cand
        if fix_scale:
            # stereo/RGB-D: collapse a residual scale to SE3 as [R | t/s]
            S_cur_new[:3, :] /= scale if scale != 0 else 1.0
        inv_T_cur_old = np.linalg.inv(T_cur_old)
        corrected = {kf_id} | {k for k, _ in m.covisible_keyframes(kf_id)}
        # pre-correction poses (NonCorrectedSim3, LoopClosing.cc:438-447)
        uncorrected = {k: m.kf_pose[k].copy() for k in corrected}
        # corrected Sim3 per neighbourhood KF (CorrectedSim3): g2oCorrectedSiw
        # = g2oSic * mg2oScw (LoopClosing.cc:460-464), right-composed
        corrected_sim3: Dict[int, tuple] = {}
        # the KF that moves each point (mnCorrectedByKF/mnCorrectedReference)
        corrected_ref: Dict[int, int] = {}
        seen = np.zeros(m.n_points, bool)
        for k in corrected:
            T_old = uncorrected[k].astype(np.float64)
            S_new = T_old @ inv_T_cur_old @ S_cur_new
            s_k = float(np.cbrt(np.linalg.det(S_new[:3, :3])))
            R_k = S_new[:3, :3] / s_k
            t_k = S_new[:3, 3]
            corrected_sim3[k] = (R_k.astype(np.float32), t_k.astype(np.float32), s_k)
            # stored SE3 pose is [R | t/s] (LoopClosing.cc:488-496)
            T_new = np.eye(4, dtype=np.float32)
            T_new[:3, :3] = R_k
            T_new[:3, 3] = t_k / s_k
            m.set_kf_pose(k, T_new)
            # move the KF's unclaimed live points through the scaled Sim3:
            # p_new = Swi_corr.map(Siw_old.map(p)) (LoopClosing.cc:499-505)
            frame = m.kf_frames[k]
            pids = frame.map_pt[frame.map_pt >= 0]
            pids = np.unique(pids[m.pt_alive[pids] & ~seen[pids]])
            if len(pids) == 0:
                continue
            seen[pids] = True
            for pid in pids:
                corrected_ref[int(pid)] = k
            p = m.pt_pos[pids].astype(np.float64)
            pc = p @ T_old[:3, :3].T + T_old[:3, 3]
            m.pt_pos[pids] = (((pc - t_k) @ R_k) / s_k).astype(np.float32)
        return corrected, uncorrected, corrected_sim3, corrected_ref

    def _correct_loop(self, kf_id: int, loop_kf: int, S_corr,
                      matched: Optional[Dict[int, int]] = None, fix_scale: bool = True):
        """Propagate the loop correction, fuse the loop sides, and run the
        essential graph + the deferred global BA."""
        # merge any earlier deferred GBA before correcting on top of it
        self.collect_gba()
        m = self.map
        # a correction rewrites poses + points wholesale: resync the mirror
        m.mark_all_dirty()
        corrected, uncorrected, corrected_sim3, corrected_ref = (
            self._propagate_correction(kf_id, loop_kf, S_corr, fix_scale))

        # covisibility before any fusion: connections the loop fuse creates
        # are the essential graph's loop edges (LoopClosing.cc:553-571)
        prev_nb = {k: {nb for nb, _ in m.covisible_keyframes(k)} for k in corrected}

        # "Start Loop Fusion" (LoopClosing.cc:523-541): the Sim3-verified
        # matches replace the current keyframe's duplicates; the loop point wins
        cur_frame = m.kf_frames[kf_id]
        for cur_feat, loop_pid in (matched or {}).items():
            if not m.pt_alive[loop_pid]:
                continue
            existing = int(cur_frame.map_pt[cur_feat])
            if existing >= 0 and m.pt_alive[existing]:
                if existing != loop_pid:
                    self._replace_point(loop_pid, existing)
                    m.compute_distinctive_descriptor(loop_pid)
                    m.update_normal_and_depth(loop_pid)
            elif kf_id not in m.pt_obs[loop_pid]:
                m.add_observation(loop_pid, kf_id, cur_feat)
                cur_frame.map_pt[cur_feat] = loop_pid
                m.compute_distinctive_descriptor(loop_pid)
        # fuse the loop side's map points into the corrected neighbourhood
        # (LoopClosing::SearchAndFuse, LoopClosing.cc:547-582)
        self._search_and_fuse(sorted(corrected), loop_kf)
        loop_connections: Dict[int, Dict[int, int]] = {}
        for k in corrected:
            new_nb = {nb: w for nb, w in m.covisible_keyframes(k)
                      if nb not in prev_nb[k] and nb not in corrected}
            if new_nb:
                loop_connections[k] = new_nb

        self._run_essential_graph(kf_id, loop_kf, uncorrected, loop_connections, corrected_ref,
                                  corrected_sim3=corrected_sim3, fix_scale=fix_scale)
        # full map refinement (40 LM iterations, the reference's choice),
        # solved now and merged at tracking's next poll (collect_gba)
        self.pending_gba = global_bundle_adjustment_async(self.cfg, m, self.device, n_iters=40)
        if not self.async_gba and self.pending_gba is not None:
            apply_global_ba(self.pending_gba, m)
            self.pending_gba = None

    def collect_gba(self, only_if_ready: bool = False) -> bool:
        """Merge a pending deferred global BA into the (possibly grown) map,
        the reference's RunGlobalBundleAdjustment merge-back. Returns True
        if a merge happened. only_if_ready is the reference's non-blocking
        probe (tracking's per-frame poll); the port's global BA solves at
        dispatch, so a pending result is always ready and the probe merges
        it too. The handle is taken under the map lock (tracking's poll and
        the worker's loop-closing hook can race here)."""
        with self.map.lock:
            h = self.pending_gba
            if h is None:
                return False
            self.pending_gba = None
        apply_global_ba(h, self.map)
        return True

    def _replace_point(self, keep: int, kill: int):
        """MapPoint::Replace (the loop point `keep` wins): absorb `kill`'s
        observations, rewire every observing frame's feature slot, and
        retire `kill`."""
        m = self.map
        for okf, ofeat in list(m.pt_obs[kill].items()):
            of = m.kf_frames[okf]
            if okf not in m.pt_obs[keep]:
                m.add_observation(keep, okf, ofeat)
                of.map_pt[ofeat] = keep
            else:
                of.map_pt[ofeat] = -1
        m.retire_point(kill)
        m.pt_found[keep] += m.pt_found[kill]
        m.pt_visible[keep] += m.pt_visible[kill]

    def _search_and_fuse(self, corrected_kfs, loop_kf: int):
        """LoopClosing::SearchAndFuse (547-582): project the loop side's map
        points (the loop KF and its covisibles) into every corrected
        keyframe at its corrected pose, radius 4 (ORBmatcher::Fuse(Scw, ...)
        th=4, no reprojection gate: ``fuse_into_keyframes(scw=True)``), in
        fixed (16 targets x 4096 points) tiles; on a conflict the LOOP
        point wins (pRep->Replace(pLoopMP))."""
        m = self.map
        cam = self.cfg.camera
        dev = self.device
        loop_side = [loop_kf] + [k for k, _ in m.covisible_keyframes(loop_kf)]
        chunks_pts = [m.kf_frames[k].map_pt for k in loop_side if m.kf_alive[k]]
        if chunks_pts:
            allp = np.concatenate(chunks_pts)
            allp = allp[allp >= 0]
            loop_pts = np.unique(allp[m.pt_alive[allp]])
        else:
            loop_pts = np.zeros(0, np.int64)
        targets = [k for k in corrected_kfs if m.kf_alive[k]]
        if len(loop_pts) == 0 or not targets:
            return
        pid_arr = np.asarray(loop_pts, np.int64)
        T_CH, P_CH = 16, 4096
        sf = m.scale_factors
        f32 = np.float32
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
        tail = (self._up(np.asarray(sf, f32)),
                f(np.log(sf[1] / sf[0]) if len(sf) > 1 else 1.0),
                f(cam.fx), f(cam.fy), f(cam.cx), f(cam.cy), f(cam.width), f(cam.height),
                f(cam.bf), f(4.0))
        t_chunks = [targets[i:i + T_CH] for i in range(0, len(targets), T_CH)]

        def ur_of(fr):
            if getattr(fr, "ur_dev", None) is not None:
                return fr.ur_dev
            return self._up(np.asarray(fr.u_right, f32))

        kf_stacks = []
        for tch in t_chunks:
            frames = [m.kf_frames[k] for k in tch]
            frames = frames + [frames[0]] * (T_CH - len(frames))
            kf_T = np.stack([m.kf_pose[k] for k in tch]
                            + [m.kf_pose[tch[0]]] * (T_CH - len(tch))).astype(f32)
            kf_stacks.append((
                torch.stack([fr.kp.xy for fr in frames]),
                torch.stack([fr.kp.octave for fr in frames]),
                torch.stack([fr.kp.desc for fr in frames]),
                torch.stack([fr.kp.valid for fr in frames]),
                torch.stack([ur_of(fr) for fr in frames]),
                self._up(kf_T)))
        flats = []
        for p0 in range(0, len(pid_arr), P_CH):
            pch = pid_arr[p0:p0 + P_CH]
            npch = len(pch)
            pos = np.zeros((P_CH, 3), f32)
            desc = np.zeros((P_CH, 32), np.uint8)
            normal = np.zeros((P_CH, 3), f32)
            mind = np.ones(P_CH, f32)
            maxd = np.ones(P_CH, f32)
            pos[:npch] = m.pt_pos[pch]
            desc[:npch] = m.pt_desc[pch]
            normal[:npch] = m.pt_normal[pch]
            mind[:npch] = m.pt_min_dist[pch]
            maxd[:npch] = m.pt_max_dist[pch]
            masks = []
            for tch in t_chunks:
                mask = np.zeros((T_CH, P_CH), bool)
                mask[: len(tch), :npch] = True
                masks.append(mask)
            # the point tables and every target chunk's mask: one packed copy
            up = argpack.upload([pos, desc, normal, mind, maxd, *masks], dev)
            pts, masks = up[:5], up[5:]
            for ti, tch in enumerate(t_chunks):
                flat = match_ops.fuse_into_keyframes_compact(
                    *kf_stacks[ti], *pts, masks[ti], *tail, scw=True)
                flats.append((tch, pch, flat))

        touched = set()
        n_replaced = n_added = 0
        merge_dists = []
        for tch, pch, flat in flats:
            flat = flat.cpu().numpy()
            triples = flat[:-1].reshape(match_ops.F_CAP, 3)
            count = int(flat[-1])
            triples = triples[: min(count, match_ops.F_CAP)].astype(np.int64)
            triples = triples[triples[:, 0] < len(tch)]
            for t, i, feat in triples:
                nb = tch[int(t)]
                frame = m.kf_frames[nb]
                pid = int(pch[i])
                if not m.pt_alive[pid] or nb in m.pt_obs[pid]:
                    continue
                feat = int(feat)
                existing = int(frame.map_pt[feat])
                if existing >= 0 and m.pt_alive[existing]:
                    if existing == pid:
                        continue
                    n_replaced += 1
                    merge_dists.append(float(np.linalg.norm(m.pt_pos[pid] - m.pt_pos[existing])))
                    self._replace_point(pid, existing)
                    touched.add(pid)
                else:
                    m.add_observation(pid, nb, feat)
                    frame.map_pt[feat] = pid
                    touched.add(pid)
                    n_added += 1
        alive_touched = [p for p in touched if m.pt_alive[p]]
        m.compute_distinctive_descriptor_batch(alive_touched)
        m.update_normal_and_depth_batch(alive_touched)
        self.last_fuse_stats = {
            "targets": len(targets), "loop_pts": len(loop_pts),
            "replaced": n_replaced, "added": n_added,
            "merge_dist_med": float(np.median(merge_dists)) if merge_dists else 0.0,
            "merge_dist_p90": float(np.percentile(merge_dists, 90)) if merge_dists else 0.0,
        }

    def _run_essential_graph(
        self,
        kf_id: int,
        loop_kf: int,
        uncorrected: Optional[Dict[int, np.ndarray]] = None,
        loop_connections: Optional[Dict[int, Dict[int, int]]] = None,
        corrected_ref: Optional[Dict[int, int]] = None,
        corrected_sim3: Optional[Dict[int, tuple]] = None,
        fix_scale: bool = True,
    ):
        """Optimizer::OptimizeEssentialGraph (Optimizer.cc:1753-2016).

        Vertex init = current poses, the corrected neighbourhood's seeded
        from the full CorrectedSim3 (scale included); the loop keyframe is
        the fixed gauge. Loop edges (the fuse's new covisibility
        connections, weight >= 100, and the cur<->loop pair) are measured
        from the CORRECTED Sim3s; normal edges (the sequential
        spanning-tree surrogate, covisibility >= 100, past loop closures)
        from the PRE-correction poses (NonCorrectedSim3). Afterwards every
        map point moves by its reference keyframe's Sim3 delta (points the
        correction already moved use the keyframe that moved them)."""
        m = self.map
        uncorrected = uncorrected or {}
        loop_connections = loop_connections or {}
        corrected_ref = corrected_ref or {}
        corrected_sim3 = corrected_sim3 or {}
        alive = [k for k in range(m.n_keyframes) if m.kf_alive[k]]
        slot = {k: i for i, k in enumerate(alive)}
        K = len(alive)

        def scw(k, corrected_meas):
            """vScw as a 4x4 [sR|t]: the corrected Sim3 in the neighbourhood
            for corrected edges; NonCorrectedSim3 (the pre-correction SE3)
            otherwise; the current pose outside the neighbourhood."""
            if corrected_meas and k in corrected_sim3:
                R, t, s = corrected_sim3[k]
                M = np.eye(4)
                M[:3, :3] = s * np.asarray(R, np.float64)
                M[:3, 3] = t
                return M
            if not corrected_meas:
                return uncorrected.get(k, m.kf_pose[k]).astype(np.float64)
            return m.kf_pose[k].astype(np.float64)

        inserted = set()
        e_i, e_j, e_R, e_t, e_s = [], [], [], [], []

        def add_edge(a, b, corrected_meas):
            key = (min(a, b), max(a, b))
            if key in inserted or a not in slot or b not in slot:
                return
            inserted.add(key)
            # Sji = Sjw o Siw^-1 (4x4 [sR|t] compose and invert as Sim3s)
            Sji = scw(b, corrected_meas) @ np.linalg.inv(scw(a, corrected_meas))
            s_ji = float(np.cbrt(np.linalg.det(Sji[:3, :3])))
            e_i.append(slot[a])
            e_j.append(slot[b])
            e_R.append(Sji[:3, :3] / s_ji)
            e_t.append(Sji[:3, 3])
            e_s.append(s_ji)

        # loop edges first (corrected measurements)
        add_edge(kf_id, loop_kf, True)
        for a, nbs in loop_connections.items():
            for b, w in nbs.items():
                if w >= 100:
                    add_edge(a, b, True)
        # normal edges (pre-correction measurements)
        for a, b in self.loop_edges:
            add_edge(a, b, False)
        for k in alive:
            if k - 1 in slot:
                add_edge(k - 1, k, False)
            for nb, w in m.covisible_keyframes(k):
                if w >= 100:
                    add_edge(k, nb, False)

        # vertex init: the full corrected Sim3 in the neighbourhood, SE3
        # elsewhere (Optimizer.cc:1814-1831)
        R0 = m.kf_pose[alive][:, :3, :3].astype(np.float32).copy()
        t0 = m.kf_pose[alive][:, :3, 3].astype(np.float32).copy()
        s0 = np.ones(K, np.float32)
        for k, (Rk, tk, sk) in corrected_sim3.items():
            if k in slot:
                i = slot[k]
                R0[i], t0[i], s0[i] = Rk, tk, sk

        # padded to power-of-two vertex/edge counts: padding vertices are
        # fixed identity Sim3s with no edges, padding edges invalid
        E = len(e_i)
        K_cap = 64
        while K_cap < K:
            K_cap *= 2
        E_cap = 512
        while E_cap < max(E, 1):
            E_cap *= 2
        R_pad = np.tile(np.eye(3, dtype=np.float32), (K_cap, 1, 1))
        t_pad = np.zeros((K_cap, 3), np.float32)
        s_pad = np.ones(K_cap, np.float32)
        R_pad[:K], t_pad[:K], s_pad[:K] = R0, t0, s0
        fixed_pad = np.ones(K_cap, bool)
        fixed_pad[:K] = np.array([k == loop_kf for k in alive])
        ei_pad = np.zeros(E_cap, np.int32)
        ej_pad = np.zeros(E_cap, np.int32)
        eR_pad = np.tile(np.eye(3, dtype=np.float32), (E_cap, 1, 1))
        et_pad = np.zeros((E_cap, 3), np.float32)
        es_pad = np.ones(E_cap, np.float32)
        ev_pad = np.zeros(E_cap, bool)
        if E:
            ei_pad[:E] = np.array(e_i, np.int32)
            ej_pad[:E] = np.array(e_j, np.int32)
            eR_pad[:E] = np.stack(e_R).astype(np.float32)
            et_pad[:E] = np.stack(e_t).astype(np.float32)
            es_pad[:E] = np.array(e_s, np.float32)
            ev_pad[:E] = True
        prob = eg.EGProblem(*(self._up(a) for a in (
            R_pad, t_pad, s_pad, fixed_pad, ei_pad, ej_pad, eR_pad, et_pad, es_pad, ev_pad)))
        R_opt, t_opt, s_opt = eg.optimize_essential_graph(prob, fix_scale=fix_scale)
        out = torch.cat([R_opt.reshape(-1), t_opt.reshape(-1), s_opt]).cpu().numpy()
        R_opt = out[: K_cap * 9].reshape(K_cap, 3, 3)[:K].astype(np.float64)
        t_opt = out[K_cap * 9: K_cap * 12].reshape(K_cap, 3)[:K].astype(np.float64)
        s_opt = out[K_cap * 12:][:K].astype(np.float64)
        self.loop_edges.add((min(kf_id, loop_kf), max(kf_id, loop_kf)))

        # per-KF Sim3 delta (vertex init -> optimized); each point moves by
        # its reference keyframe's: p_new = correctedSwr.map(Srw.map(p))
        # (Optimizer.cc:1964-2014)
        M_init = np.tile(np.eye(4), (K, 1, 1))
        M_init[:, :3, :3] = s0[:, None, None] * R0.astype(np.float64)
        M_init[:, :3, 3] = t0
        M_new = np.tile(np.eye(4), (K, 1, 1))
        M_new[:, :3, :3] = s_opt[:, None, None] * R_opt
        M_new[:, :3, 3] = t_opt
        deltas_arr = np.linalg.inv(M_new) @ M_init       # (K, 4, 4)
        for i, k in enumerate(alive):
            # stored SE3 pose = [R | t/s] (Optimizer.cc:1950-1961)
            T_new = np.eye(4, dtype=np.float32)
            T_new[:3, :3] = R_opt[i]
            T_new[:3, 3] = t_opt[i] / max(s_opt[i], 1e-9)
            m.set_kf_pose(k, T_new)
        n_pts = m.n_points
        ref = m.pt_ref_kf[:n_pts].copy()
        for pid, k in corrected_ref.items():
            if pid < n_pts:
                ref[pid] = k
        slot_arr = np.full(m.n_keyframes, -1, np.int64)
        for i, k in enumerate(alive):
            slot_arr[k] = i
        ok_ref = (ref >= 0) & (ref < m.n_keyframes)
        ref_slot = np.where(ok_ref, slot_arr[np.maximum(ref, 0)], -1)
        sel = m.pt_alive[:n_pts] & (ref_slot >= 0)
        pids = np.nonzero(sel)[0]
        if len(pids):
            D = deltas_arr[ref_slot[pids]]
            p = m.pt_pos[pids].astype(np.float64)
            m.pt_pos[pids] = (np.einsum("nij,nj->ni", D[:, :3, :3], p)
                              + D[:, :3, 3]).astype(np.float32)
            m.update_normal_and_depth_batch(pids)
