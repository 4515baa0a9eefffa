"""Bundle-adjustment window assembly (Optimizer.cc:505-871 local BA;
Optimizer.cc:51-249 global BA).

Port of the synchronous local-BA and the global-BA paths of
``iv_slam_tpu/solvers/local_ba.py``:
the host gathers a keyframe/point window, packs padded edge arrays at one
of three rung sizes, runs the Schur LM (ba_core.py) on the map's device
with one upload of the problem and one download of the result, and writes
the result back into the map store, erasing the observations that end as
outliers as the reference's joint erase pass does (Optimizer.cc:820-850).
The host bookkeeping is numpy, order for order the reference's: it decides
which points survive.

``local_bundle_adjustment_vis`` adds the reference's per-point quality
update from the final chi2 of each point's edges (Optimizer.cc:873-1293);
``constrained_local_bundle_adjustment`` is IV-SLAM's guided BA
(Optimizer.cc:1295-1751): keyframe poses pinned to ground truth, only the
points solved, nothing erased, and each observation's chi2 a keypoint
quality label.

Global BA (loop closing): ``global_bundle_adjustment`` blocks;
``global_bundle_adjustment_async`` solves when it is dispatched and holds
the result on the device in a ``GBAHandle``, and ``apply_global_ba``
merges it later into a map that kept growing, the reference's
RunGlobalBundleAdjustment merge-back (LoopClosing.cc:649-745).

The async local BA, the reference's threaded-LocalMapping semantics
(tracking never waits for Optimizer::LocalBundleAdjustment):
``local_bundle_adjustment_async`` assembles the window (under the caller's
map lock) and returns an ``LBAHandle``; ``apply_local_ba`` merges the
result later into a map that kept changing, revalidating every write:
points killed or re-observed meanwhile keep their newer state. The port's
LM reads a flag on the host at every trial, so a solve cannot be
dispatched and left running on the calling thread. It leaves that thread
instead: segmented (the LocalMapping worker), ``LBAHandle.drive`` steps
the reference's LM segments (``BA_SEGMENTS``) on the worker, off the map
lock; unsegmented (async BA without the worker), ``LBAHandle.start`` runs
the same segments on the LocalMapping's helper thread and ``is_ready`` is
its future's ``done()``. Either way the solve is the synchronous one's,
bit for bit.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..geometry import camera
from ..utils import argpack
from .ba_core import BAProblem, _Ctx, ba_solve


# Local BA runs at every keyframe event on one of three padded sizes
# (small / medium / full). Windows beyond the last rung are trimmed
# (weakest-covisibility keyframes, least-observed points, strided edge
# subsample): a deliberate deviation from the reference, which lets local
# BA grow without bound (Optimizer.cc:505-544).
LBA_RUNGS = (
    # (n_kf, n_pt, n_e)
    (32, 2048, 4096),
    (64, 8192, 16384),
    (64, 16384, 32768),
)


# Global BA (loop closing's deferred GBA) rungs: at most 4 padded shapes
# a session; maps beyond the last rung take the open grid below
GBA_RUNGS = (
    (64, 8192, 16384),
    (64, 16384, 32768),
    (128, 32768, 65536),
    (256, 65536, 131072),
)


def _bucket(n: int, quantum: int = 2048) -> int:
    """Pad to a coarse fixed grid (the blocking global BA's sizes)."""
    return max(quantum, ((n + quantum - 1) // quantum) * quantum)


def _bucket_kf(n: int) -> int:
    return max(32, ((n + 31) // 32) * 32)


def _pick_rung(table, n_kf: int, n_pt: int, n_e: int):
    """Smallest rung that fits (n_kf, n_pt, n_e); None if none fits."""
    for rung in table:
        if n_kf <= rung[0] and n_pt <= rung[1] and n_e <= rung[2]:
            return rung
    return None


def _lba_rung(n_kf: int, n_pt: int, n_e: int):
    """Smallest rung that fits (n_kf, n_pt, n_e); the last rung if none."""
    r = _pick_rung(LBA_RUNGS, n_kf, n_pt, n_e)
    return r if r is not None else LBA_RUNGS[-1]


def _assemble(cfg, m, local_kfs, fixed_kfs, pts, extra_fixed=frozenset(), gba_rungs=None):
    """Pack a keyframe/point window into a host (numpy) BAProblem. Returns
    (prob, all_kfs, e_feat, E) or None when the window is degenerate.

    Local BA (gba_rungs None) pads to the smallest of LBA_RUNGS that fits,
    else to the last with a strided edge subsample; global BA to the
    smallest of gba_rungs that fits, else to the open grid of
    ``_bucket``/``_bucket_kf``."""
    all_kfs = list(local_kfs) + list(fixed_kfs)
    kf_slot = {k: i for i, k in enumerate(all_kfs)}
    if len(pts) == 0 or len(all_kfs) < 2:
        return None

    # edges per keyframe: each window frame's map_pt array IS its
    # observation list (kept in lockstep with pt_obs by the map store)
    pt_lookup = np.full(m.n_points, -1, np.int32)
    pt_lookup[np.asarray(pts)] = np.arange(len(pts), dtype=np.int32)
    inv_sigma2 = 1.0 / (m.scale_factors ** 2)
    cols_kf, cols_pt, cols_obs, cols_inv, cols_qual = [], [], [], [], []
    e_feat = []
    for k in all_kfs:
        frame = m.kf_frames[k]
        feats = np.nonzero(frame.map_pt >= 0)[0]
        pids = frame.map_pt[feats]
        sl = pt_lookup[pids]
        keep = sl >= 0
        # only edges the observation dicts confirm
        if keep.any():
            idx = np.nonzero(keep)[0]
            confirm = np.fromiter(
                (m.pt_obs[int(pids[i])].get(k) == int(feats[i]) for i in idx),
                bool, len(idx))
            keep[idx] = confirm
        feats, pids, sl = feats[keep], pids[keep], sl[keep]
        if len(feats) == 0:
            continue
        cols_kf.append(np.full(len(feats), kf_slot[k], np.int32))
        cols_pt.append(sl.astype(np.int32))
        cols_obs.append(np.stack(
            [frame.xy[feats, 0], frame.xy[feats, 1], frame.u_right[feats]],
            axis=1).astype(np.float32))
        cols_inv.append(inv_sigma2[frame.octave[feats]].astype(np.float32))
        if cfg.iv.propagate_keyptqual:
            cols_qual.append(m.pt_quality[pids].astype(np.float32))
        else:
            cols_qual.append(frame.qual_score[feats].astype(np.float32))
        e_feat.extend((int(p), k, int(f)) for p, f in zip(pids, feats))
    if not cols_kf:
        return None
    e_kf = np.concatenate(cols_kf)
    e_pt = np.concatenate(cols_pt)
    e_obs = np.concatenate(cols_obs)
    e_inv = np.concatenate(cols_inv)
    e_qual = np.concatenate(cols_qual)
    if len(e_kf) < 10:
        return None

    sizes = (len(all_kfs), len(pts), len(e_kf))
    if gba_rungs is not None:
        rung = _pick_rung(gba_rungs, *sizes) or (
            _bucket_kf(sizes[0]), _bucket(sizes[1]), _bucket(sizes[2]))
    else:
        rung = _lba_rung(*sizes)
    n_kf, n_pt, n_e = rung
    if len(e_kf) > n_e:
        # strided subsample keeps per-keyframe proportions roughly
        # intact (edges are concatenated per keyframe in order)
        keep = np.linspace(0, len(e_kf) - 1, n_e).astype(np.int64)
        e_kf, e_pt, e_obs = e_kf[keep], e_pt[keep], e_obs[keep]
        e_inv, e_qual = e_inv[keep], e_qual[keep]
        e_feat = [e_feat[i] for i in keep]

    kf_pose = np.zeros((n_kf, 4, 4), np.float32)
    kf_pose[:, range(4), range(4)] = 1.0
    kf_pose[: len(all_kfs)] = m.kf_pose[all_kfs]
    kf_fixed = np.ones(n_kf, bool)
    for i, k in enumerate(all_kfs):
        # the origin keyframe stays fixed even when local (Optimizer.cc:545)
        kf_fixed[i] = (i >= len(local_kfs)) or (k == m.origin_kf) or (k in extra_fixed)

    pt_pos = np.zeros((n_pt, 3), np.float32)
    pt_pos[: len(pts)] = m.pt_pos[pts]
    pt_valid = np.zeros(n_pt, bool)
    pt_valid[: len(pts)] = True

    E = len(e_kf)
    prob = BAProblem(
        kf_pose=kf_pose,
        kf_fixed=kf_fixed,
        pt_pos=pt_pos,
        pt_valid=pt_valid,
        e_kf=np.pad(np.array(e_kf, np.int32), (0, n_e - E)),
        e_pt=np.pad(np.array(e_pt, np.int32), (0, n_e - E)),
        e_obs=np.pad(np.array(e_obs, np.float32), ((0, n_e - E), (0, 0)),
                     constant_values=-1.0),
        e_inv_s2=np.pad(np.array(e_inv, np.float32), (0, n_e - E)),
        e_qual=np.pad(np.array(e_qual, np.float32), (0, n_e - E), constant_values=1.0),
        e_valid=np.pad(np.ones(E, bool), (0, n_e - E), constant_values=False),
    )
    return prob, all_kfs, e_feat, E


def _trim_window(m, local_kfs, fixed_kfs, pts):
    """Shrink an oversized local-BA window to the largest LBA rung:
    weakest-covisibility local keyframes, then most-redundant fixed
    keyframes, then least-observed points are dropped first. local_kfs is
    ordered [kf_id, covisibles by weight desc]; fixed_kfs in
    first-encountered order."""
    max_kf, max_pt, _ = LBA_RUNGS[-1]
    if len(local_kfs) > max_kf - 8:
        local_kfs = local_kfs[: max_kf - 8]  # keep slots for anchors
    if len(local_kfs) + len(fixed_kfs) > max_kf:
        budget = max_kf - len(local_kfs)
        # rank fixed keyframes by how many window points they anchor
        in_window = set(pts)
        scores = []
        for k in fixed_kfs:
            frame = m.kf_frames[k]
            pids = frame.map_pt[frame.map_pt >= 0]
            scores.append(sum(1 for p in pids if int(p) in in_window))
        order = np.argsort(scores)[::-1][:budget]
        fixed_kfs = [fixed_kfs[i] for i in sorted(order)]
    if len(pts) > max_pt:
        obs_counts = np.array([m.n_observations(p) for p in pts])
        keep = np.argsort(obs_counts)[::-1][:max_pt]
        kept = set(np.asarray(pts)[keep].tolist())
        pts = [p for p in pts if p in kept]
    return local_kfs, fixed_kfs, pts


def _upload(prob_np, device) -> BAProblem:
    """A BAProblem of host arrays (or tensors) on `device`: the host
    fields ride one packed copy (utils/argpack.py)."""
    return argpack.to_device(BAProblem(*prob_np), device)


def _solve(cfg, prob_np, device, **opts):
    """ba_solve of a host BAProblem on `device` (one upload)."""
    return ba_solve(_upload(prob_np, device),
                    camera.Intrinsics.from_config(cfg.camera, device), **opts)


# The async local BA's segment plan: phase 1 = 3 + 2 robust iterations,
# phase 2 = 4 + 3 + 3 kernel-off iterations, ba_solve(n_iters1=5,
# n_iters2=10, kernel2=False) cut at the reference's points
BA_SEGMENTS = ((3, 2), (4, 3, 3))


def _ba_solve_segmented_driver(prob, K, segs=BA_SEGMENTS, kernel2=False,
                               midpoint_gate=True):
    """A drive() callable that uploads `prob` (host arrays or tensors) to
    K's device, steps the LM segments with (lam, ni, chi) carried between
    them, and returns the BAResult: ba_solve's arithmetic, bit for bit.
    Nothing runs before drive(): the caller assembles under the map lock
    and drives off it."""

    def drive():
        prob_d = _upload(prob, K.fx.device)
        ctx = _Ctx(prob_d, K)
        segs1, segs2 = segs
        kf, pt = prob_d.kf_pose, prob_d.pt_pos
        lam = ni = chi = None
        for i, n in enumerate(segs1):
            kf, pt, lam, ni, chi = ctx.segment(kf, pt, lam, ni, chi, prob_d.e_valid, True, n,
                                               init=i == 0)
        mask2 = ctx.midpoint(kf, pt) if midpoint_gate else prob_d.e_valid
        for i, n in enumerate(segs2):
            kf, pt, lam, ni, chi = ctx.segment(kf, pt, lam, ni, chi, mask2, kernel2, n,
                                               init=i == 0)
        return ctx.finalize(kf, pt)

    return drive


def _run_ba(cfg, m, local_kfs, fixed_kfs, pts, device, return_edges=False):
    """Trim the window to the largest rung, assemble, solve on `device`
    (one upload, one download) and write back, erasing the observations
    that end as outliers. Returns the rung (n_kf, n_pt, n_e) solved, or
    None; with return_edges, (rung, (pts, e_feat, chi2, inlier)) with each
    edge's (point, keyframe, feature), final chi2 and inlier flag."""
    local_kfs, fixed_kfs, pts = _trim_window(m, local_kfs, fixed_kfs, pts)
    packed = _assemble(cfg, m, local_kfs, fixed_kfs, pts)
    if packed is None:
        return None
    prob_np, all_kfs, e_feat, E = packed
    res = _solve(cfg, prob_np, device)
    # one download for everything host-bound
    parts = [res.kf_pose.reshape(-1), res.pt_pos.reshape(-1), res.e_inlier.to(torch.float32)]
    if return_edges:
        parts.append(res.e_chi2)
    flat = torch.cat(parts).cpu().numpy()
    n_kf, n_pt = prob_np.kf_pose.shape[0], prob_np.pt_pos.shape[0]
    n_e = prob_np.e_obs.shape[0]
    new_poses = flat[: n_kf * 16].reshape(n_kf, 4, 4)
    at = n_kf * 16 + n_pt * 3
    new_pts = flat[n_kf * 16: at].reshape(n_pt, 3)
    inlier_all = flat[at: at + n_e] != 0.0

    kf_fixed = prob_np.kf_fixed
    for i, k in enumerate(all_kfs[: len(local_kfs)]):
        if not kf_fixed[i]:
            m.set_kf_pose(k, new_poses[i])
    m.pt_pos[pts] = new_pts[: len(pts)]
    m.mark_dirty(pts)

    for idx in np.nonzero(~inlier_all[:E])[0]:
        pid, k, feat = e_feat[idx]
        if m.pt_alive[pid] and m.pt_obs[pid].get(k) == feat:
            m.kf_frames[k].map_pt[feat] = -1
            m.erase_observation(pid, k)
    m.update_normal_and_depth_batch([p for p in pts if m.pt_alive[p]])
    rung = (n_kf, n_pt, n_e)
    if return_edges:
        return rung, (pts, e_feat, flat[at + n_e: at + n_e + E], inlier_all[:E])
    return rung


def _local_window(m, kf_id: int):
    """(local_kfs, fixed_kfs, pts) for Optimizer::LocalBundleAdjustment."""
    local_kfs = [kf_id] + [k for k, _ in m.covisible_keyframes(kf_id)]
    local_kfs = [k for k in local_kfs if m.kf_alive[k]]
    local_set = set(local_kfs)

    pts = set()
    for k in local_kfs:
        frame = m.kf_frames[k]
        for pid in frame.map_pt[frame.map_pt >= 0]:
            if m.pt_alive[pid]:
                pts.add(int(pid))
    pts = sorted(pts)
    if not pts or len(local_kfs) < 2:
        return None

    fixed_kfs = []
    for pid in pts:
        for k in m.pt_obs[pid]:
            if k not in local_set and m.kf_alive[k] and k not in fixed_kfs:
                fixed_kfs.append(k)
    return local_kfs, fixed_kfs, pts


def local_bundle_adjustment(cfg, m, kf_id: int, device, return_edges=False):
    """Covisibility-window BA (Optimizer::LocalBundleAdjustment) on
    `device`. Returns the rung solved, or None (with return_edges, what
    ``_run_ba`` returns)."""
    win = _local_window(m, kf_id)
    if win is None:
        return None
    local_kfs, fixed_kfs, pts = win
    return _run_ba(cfg, m, local_kfs, fixed_kfs, pts, device, return_edges)


class LBAHandle:
    """An in-flight local BA: the assembled window and the solve that has
    yet to run (``drive``) or runs on a helper thread (``start``); merged by
    ``apply_local_ba`` when ready or at the next forced join (the next
    keyframe event, a loop correction, a trajectory save)."""

    def __init__(self, driver, all_kfs, kf_fixed, n_local, pts, e_feat, E, rung):
        self._driver = driver
        self._drive_lock = threading.Lock()
        self._future = None
        self.flat = None          # the result flattened on the device
        self.all_kfs = all_kfs
        self.kf_fixed = kf_fixed
        self.n_local = n_local
        self.pts = pts
        self.e_feat = e_feat
        self.E = E
        self.rung = rung          # (n_kf, n_pt, n_e) of the padded problem

    def drive(self):
        """Run the solve on the calling thread (idempotent, thread-safe: the
        worker and a forced join may race here). A failed solve raises and
        stays pending."""
        with self._drive_lock:
            if self._driver is not None:
                res = self._driver()
                self.flat = torch.cat([res.kf_pose.reshape(-1), res.pt_pos.reshape(-1),
                                       res.e_inlier.to(torch.float32), res.e_chi2])
                self._driver = None

    def start(self, executor):
        """Run the solve on `executor`'s thread."""
        self._future = executor.submit(self.drive)

    def is_ready(self) -> bool:
        if self._future is not None:
            return self._future.done()
        return self._driver is None

    def result(self):
        """The host result (one download): (poses, points, inlier, chi2).
        Waits for the helper thread, or drives a pending segmented solve;
        the solve's exception is raised here."""
        if self._future is not None:
            self._future.result()
        else:
            self.drive()
        n_kf, n_pt, n_e = self.rung
        flat = self.flat.cpu().numpy()
        o1, o2 = n_kf * 16, n_kf * 16 + n_pt * 3
        return (flat[:o1].reshape(n_kf, 4, 4), flat[o1:o2].reshape(n_pt, 3),
                flat[o2:o2 + n_e] != 0.0, flat[o2 + n_e:o2 + 2 * n_e])


def local_bundle_adjustment_async(cfg, m, kf_id: int, device, segmented: bool = True,
                                  executor=None):
    """Assemble the covisibility-window BA and return its LBAHandle (None
    when degenerate); the solve steps BA_SEGMENTS. segmented=True (the
    worker): nothing is solved yet, the caller drives ``handle.drive()``
    off the map lock. segmented=False: the solve starts at once on
    `executor` (a single-thread pool). apply_local_ba merges either."""
    win = _local_window(m, kf_id)
    if win is None:
        return None
    local_kfs, fixed_kfs, pts = _trim_window(m, *win)
    packed = _assemble(cfg, m, local_kfs, fixed_kfs, pts)
    if packed is None:
        return None
    prob_np, all_kfs, e_feat, E = packed
    driver = _ba_solve_segmented_driver(prob_np, camera.Intrinsics.from_config(cfg.camera,
                                                                                device))
    rung = (prob_np.kf_pose.shape[0], prob_np.pt_pos.shape[0], prob_np.e_obs.shape[0])
    h = LBAHandle(driver, all_kfs, prob_np.kf_fixed, len(local_kfs), pts, e_feat, E, rung)
    if not segmented:
        h.start(executor)
    return h


def apply_local_ba(handle: LBAHandle, m):
    """Merge a finished (or force-joined) async local BA into the map. The
    readback runs outside the map lock, the host mutations inside it."""
    new_poses, new_pts, inlier_all, chi2_all = handle.result()
    with m.lock:
        _apply_local_ba_data(handle, m, new_poses, new_pts, inlier_all, chi2_all)


def _apply_local_ba_data(handle, m, new_poses, new_pts, inlier_all, chi2_all):
    """The synchronous write-back, revalidated against the live map: a
    keyframe culled or a point killed since the dispatch keeps its state,
    and an outlier edge is erased only while the point still has that
    observation."""
    for i, k in enumerate(handle.all_kfs[: handle.n_local]):
        if not handle.kf_fixed[i] and m.kf_alive[k]:
            m.set_kf_pose(k, new_poses[i])
    pts_arr = np.asarray(handle.pts)
    alive = m.pt_alive[pts_arr]
    m.pt_pos[pts_arr[alive]] = new_pts[: len(pts_arr)][alive]
    m.mark_dirty(pts_arr[alive])

    inlier = inlier_all[: handle.E]
    for idx in np.nonzero(~inlier)[0]:
        pid, k, feat = handle.e_feat[idx]
        if m.pt_alive[pid] and m.pt_obs[pid].get(k) == feat:
            m.kf_frames[k].map_pt[feat] = -1
            m.erase_observation(pid, k)
    m.update_normal_and_depth_batch(pts_arr[alive])


def local_bundle_adjustment_vis(cfg, m, kf_id: int, device):
    """Optimizer::LocalBundleAdjustmentVis (Optimizer.cc:873-1293): local
    BA, then each window point's quality from the summed chi2 of its edges
    against the chi-square quantile window [50%, 95%] at the point's total
    degrees of freedom (3 a stereo observation, 2 a monocular one).
    Returns the rung solved, or None."""
    from scipy.stats import chi2 as chi2_dist

    out = local_bundle_adjustment(cfg, m, kf_id, device, return_edges=True)
    if out is None:
        return None
    rung, (_, e_feat, chi2_vals, _) = out
    acc = {}
    for (pid, k, feat), c2 in zip(e_feat, chi2_vals):
        dof = 3 if m.kf_frames[k].u_right[feat] >= 0 else 2
        tot = acc.setdefault(pid, [0.0, 0])
        tot[0] += float(c2)
        tot[1] += dof
    for pid, (chi2_sum, dof) in acc.items():
        if dof < 1 or not m.pt_alive[pid]:
            continue
        th_max = chi2_dist.ppf(0.95, dof)
        th_min = chi2_dist.ppf(0.5, dof)
        scaled = np.clip((chi2_sum - th_min) / (th_max - th_min), 0.0, 1.0)
        m.pt_quality[pid] = 2.0 * (1.0 / (1.0 + scaled)) - 1.0
        m.mark_dirty(pid)
    return rung


def constrained_local_bundle_adjustment(cfg, m, kf_id: int, device):
    """Optimizer::ConstrainedLocalBundleAdjustment (Optimizer.cc:1295-1751):
    the covisibility window's keyframes pinned to their ground-truth poses
    (kept there), its points solved on `device` with no outlier erased, and
    each observation of a point seen more than twice labelled with a
    keypoint quality from its final chi2 through the [kErrMin = 1.0,
    kErrMax = 7.815] window. Returns the rung solved, or None (the window
    lacks ground truth or is degenerate; the poses are then restored)."""
    local_kfs = [kf_id] + [k for k, _ in m.covisible_keyframes(kf_id)]
    local_kfs = [k for k in local_kfs if m.kf_alive[k]]
    if len(local_kfs) < 2 or any(m.kf_gt_pose[k] is None for k in local_kfs):
        return None
    saved = {k: m.kf_pose[k].copy() for k in local_kfs}
    for k in local_kfs:
        m.set_kf_pose(k, np.linalg.inv(m.kf_gt_pose[k]).astype(np.float32))
    pts = set()
    for k in local_kfs:
        frame = m.kf_frames[k]
        for pid in frame.map_pt[frame.map_pt >= 0]:
            if m.pt_alive[pid]:
                pts.add(int(pid))
    pinned = set(local_kfs)
    local_kfs, _, pts = _trim_window(m, local_kfs, [], sorted(pts))
    packed = _assemble(cfg, m, local_kfs, [], pts, extra_fixed=pinned)
    if packed is None:
        for k, T in saved.items():
            m.set_kf_pose(k, T)
        return None
    prob_np, _all_kfs, e_feat, E = packed
    res = _solve(cfg, prob_np, device)
    n_pt = prob_np.pt_pos.shape[0]
    flat = torch.cat([res.pt_pos.reshape(-1), res.e_chi2]).cpu().numpy()
    m.pt_pos[pts] = flat[: n_pt * 3].reshape(n_pt, 3)[: len(pts)]
    m.mark_dirty(pts)
    m.update_normal_and_depth_batch([p for p in pts if m.pt_alive[p]])
    K_ERR_MIN, K_ERR_MAX = 1.0, 7.815
    for (pid, k, feat), c2 in zip(e_feat, flat[n_pt * 3: n_pt * 3 + E]):
        if m.n_observations(pid) <= 2:
            continue
        scaled = np.clip((float(c2) - K_ERR_MIN) / (K_ERR_MAX - K_ERR_MIN), 0.0, 1.0)
        m.kf_frames[k].qual_score[feat] = 2.0 * (1.0 / (1.0 + scaled)) - 1.0
    return (prob_np.kf_pose.shape[0], n_pt, prob_np.e_obs.shape[0])


class GBAHandle:
    """A deferred global BA (the reference's GBA thread, LoopClosing.cc:584):
    the solved problem's result stays on the device until
    ``apply_global_ba`` merges it, correcting keyframes and points created
    since (RunGlobalBundleAdjustment, LoopClosing.cc:649-745)."""

    def __init__(self, res, kf_ids, pt_in_snapshot, n_points_snapshot):
        self.res = res                        # BAResult (device tensors)
        self.kf_ids = kf_ids                  # snapshot keyframe ids
        self.pt_in_snapshot = pt_in_snapshot  # (n_points_snapshot,) bool
        self.n_points_snapshot = n_points_snapshot


def _dispatch_global_ba(cfg, m, device, n_iters, fixed_kfs, rungs):
    """Optimizer::GlobalBundleAdjustemnt (Optimizer.cc:51-63) solved on
    `device`: every live keyframe and point, only the origin keyframe (and
    any in fixed_kfs) anchored; one robust run, no midpoint outlier
    reclassification, Huber kept throughout, nothing erased. Padded to the
    smallest of `rungs` that fits, else to the open grid. Returns a
    GBAHandle with no host read of the result, or None when degenerate."""
    alive_kfs = [k for k in range(m.n_keyframes) if m.kf_alive[k]]
    if len(alive_kfs) < 2:
        return None
    pts = [p for p in range(m.n_points) if m.pt_alive[p] and m.pt_obs[p]]
    packed = _assemble(cfg, m, alive_kfs, [], pts, extra_fixed=set(fixed_kfs), gba_rungs=rungs)
    if packed is None:
        return None
    prob_np, all_kfs, _e_feat, _E = packed
    res = _solve(cfg, prob_np, device, n_iters1=n_iters // 2,
                 n_iters2=n_iters - n_iters // 2, kernel2=True, midpoint_gate=False)
    in_snap = np.zeros(m.n_points, bool)
    in_snap[np.asarray(pts, np.int64)] = True
    return GBAHandle(res, list(all_kfs), in_snap, m.n_points)


def global_bundle_adjustment(cfg, m, device, n_iters: int = 20, fixed_kfs=()):
    """The global BA, blocking: solved on the open grid (the reference's
    padded sizes for it) and merged at once."""
    handle = _dispatch_global_ba(cfg, m, device, n_iters, fixed_kfs, rungs=())
    if handle is not None:
        apply_global_ba(handle, m)


def global_bundle_adjustment_async(cfg, m, device, n_iters: int = 20, fixed_kfs=()):
    """The global BA solved at dispatch and padded to GBA_RUNGS; its
    GBAHandle (None when degenerate) is merged later by apply_global_ba:
    tracking goes on against the uncorrected map until then, the
    reference's concurrent-GBA semantics."""
    return _dispatch_global_ba(cfg, m, device, n_iters, fixed_kfs, rungs=GBA_RUNGS)


def apply_global_ba(handle: GBAHandle, m):
    """Merge a finished global BA into a map that kept growing (one
    download), the reference's RunGlobalBundleAdjustment merge:

    * snapshot keyframes take their optimized poses (mTcwGBA);
    * keyframes created since are corrected through the spanning tree:
      T_new = (T_child @ T_parent_before^-1) @ T_parent_GBA, parent = the
      most covisible already-corrected keyframe, in id order;
    * snapshot points take their optimized positions (mPosGBA); points
      created since ride their reference keyframe's before->after delta.
    """
    n_kf = handle.res.kf_pose.shape[0]
    flat = torch.cat([handle.res.kf_pose.reshape(-1), handle.res.pt_pos.reshape(-1)])
    flat = flat.cpu().numpy()
    with m.lock:
        _apply_global_ba_data(handle, m, flat[: n_kf * 16].reshape(n_kf, 4, 4),
                              flat[n_kf * 16:].reshape(-1, 3))


def _apply_global_ba_data(handle, m, new_kf_poses, new_pt_pos):
    slot = {k: i for i, k in enumerate(handle.kf_ids)}

    before = {}
    for k, i in slot.items():
        if not m.kf_alive[k]:
            continue
        before[k] = m.kf_pose[k].copy()
        m.set_kf_pose(k, new_kf_poses[i])
    corrected = set(before)

    # keyframes created while the GBA was pending
    new_kfs = [k for k in range(m.n_keyframes) if m.kf_alive[k] and k not in slot]
    for k in sorted(new_kfs):
        parent, best_w = -1, -1
        for nb, w in m.covisible_keyframes(k):
            if nb in corrected and w > best_w:
                parent, best_w = nb, w
        if parent < 0:
            cand = [c for c in corrected if c < k]
            if not cand:
                continue
            parent = max(cand)
        T_child = m.kf_pose[k].copy()
        T_new = (T_child @ np.linalg.inv(before[parent]) @ m.kf_pose[parent]).astype(np.float32)
        before[k] = T_child
        m.set_kf_pose(k, T_new)
        corrected.add(k)

    for pid in range(m.n_points):
        if not m.pt_alive[pid]:
            continue
        if pid < handle.n_points_snapshot and handle.pt_in_snapshot[pid]:
            continue  # snapshot points: below, vectorized
        ref = int(m.pt_ref_kf[pid])
        if ref not in before:
            continue
        pc = before[ref][:3, :3] @ m.pt_pos[pid] + before[ref][:3, 3]
        Twc = np.linalg.inv(m.kf_pose[ref])
        m.pt_pos[pid] = (Twc[:3, :3] @ pc + Twc[:3, 3]).astype(np.float32)

    snap_ids = np.nonzero(handle.pt_in_snapshot)[0]
    alive = m.pt_alive[snap_ids]
    m.pt_pos[snap_ids[alive]] = new_pt_pos[: len(snap_ids)][alive]
    m.update_normal_and_depth_batch(snap_ids[alive])
    m.mark_all_dirty()  # a global merge rewrites most live rows
