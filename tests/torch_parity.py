"""JAX references for the port's whole-pipeline parity tests.

The port reproduces the JAX package's arithmetic with every float32
multiply and add rounded on its own, as the source writes it. Under jit,
XLA:CPU fuses elementwise chains and, on a CPU with FMA instructions,
contracts some multiply-adds into one FMA (one rounding instead of two):
a handful of resize/blur pixels then move by one LSB after rounding to
uint8, and stereo depth by an ulp. Op-by-op JAX has no such contraction,
and neither has jitted JAX compiled for a CPU target without FMA
(``--xla_cpu_max_isa=AVX``): both give the same numbers.

XLA flags are read once per process, so ``run_reference`` runs the JAX
package's own jitted entry points in a subprocess started with that flag
and hands arrays back through an .npz file. Inputs are made from seeds with
numpy by the caller and passed the same way.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
NO_FMA_FLAG = "--xla_cpu_max_isa=AVX"


def run_reference(task: str, tmp_path, timeout: float = 240.0, **inputs) -> dict:
    """Run ``_task_<task>(**inputs)`` in a JAX process without FMA
    contraction; returns its dict of numpy arrays."""
    src = os.path.join(str(tmp_path), f"{task}_in.npz")
    dst = os.path.join(str(tmp_path), f"{task}_out.npz")
    np.savez(src, **inputs)
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " " + NO_FMA_FLAG).strip()
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), task, src, dst],
        env=env, cwd=os.path.dirname(HERE), capture_output=True, text=True,
        timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"JAX reference '{task}' failed:\n{proc.stderr[-4000:]}")
    with np.load(dst) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def one_thread():
    """torch on one CPU thread for a test module. The port's CPU path is
    thousands of small ops a frame; with several test workers on the
    machine, every op's parallel region waits on threads that have no core
    (a 2 s test took 329 s in a 6-worker run)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- tasks (run in the subprocess) ----------------------------------------

KP_FIELDS = ("xy", "response", "octave", "angle", "desc", "valid", "yx_level")


def _task_extract(img, n_features, n_levels, ini, min_, quality=None,
                  select_path="hist"):
    """OrbExtractor.__call__ (jitted) on one image, weighted by the uint8
    cost map `quality` when given."""
    import jax.numpy as jnp

    from iv_slam_tpu.config import ORBConfig
    from iv_slam_tpu.ops import extractor

    cfg = ORBConfig(n_features=int(n_features), n_levels=int(n_levels),
                    ini_th_fast=int(ini), min_th_fast=int(min_),
                    select_path=str(select_path))
    ext = extractor.OrbExtractor(cfg, *img.shape)
    kp = ext(jnp.asarray(img), None if quality is None else jnp.asarray(quality))
    return {f: np.asarray(getattr(kp, f)) for f in KP_FIELDS}


def _task_extract_pair(imgs, n_features, n_levels, ini, min_):
    """Batched extraction of a (2, H, W) pair, jitted, plus its canvas."""
    import jax
    import jax.numpy as jnp

    from iv_slam_tpu.config import ORBConfig
    from iv_slam_tpu.ops import extractor, pyramid

    cfg = ORBConfig(n_features=int(n_features), n_levels=int(n_levels),
                    ini_th_fast=int(ini), min_th_fast=int(min_))
    ext = extractor.OrbExtractor(cfg, *imgs.shape[1:])

    def run(pair):
        return ext.extract_from_pyramid_batched(
            pyramid.build_pyramid(pair, ext.shapes), return_canvas=True)

    kb, canvas = jax.jit(run)(jnp.asarray(imgs))
    out = {f: np.asarray(getattr(kb, f)) for f in KP_FIELDS}
    out["canvas"] = np.asarray(canvas)
    return out


def _task_iv_numerics(quals, **sums):
    """The roundings introspection rests on, jitted: the quality formula of
    every uint8 cost at /255 and /256, jnp.cumsum over rows then columns of
    each map in `quals`, and jnp.sum of each row of every `sum_<n>` array."""
    import jax
    import jax.numpy as jnp

    q = jnp.arange(256, dtype=jnp.uint8)
    out = {f"qual{d}": np.asarray(jax.jit(
        lambda q, d=d: 2.0 * (1.0 / (1.0 + q.astype(jnp.float32) / float(d))) - 1.0)(q))
        for d in (255, 256)}
    out["cumsum"] = np.asarray(jax.jit(
        lambda m: jnp.cumsum(jnp.cumsum(m, axis=1), axis=2))(jnp.asarray(quals, jnp.float32)))
    for k, v in sums.items():
        out[k] = np.asarray(jax.jit(jax.vmap(jnp.sum))(jnp.asarray(v)))
    return out


def _task_cell_budgets(quals, n_features, n_levels):
    """Per level of each cost map's pyramid: the level, the reference's
    _cell_quality_weights and the budgets _select_level_keypoints draws
    from them, vmapped over the maps and jitted."""
    import jax
    import jax.numpy as jnp

    from iv_slam_tpu.config import ORBConfig
    from iv_slam_tpu.ops import extractor, pyramid

    cfg = ORBConfig(n_features=int(n_features), n_levels=int(n_levels))
    lays = extractor.make_layouts(cfg, *quals.shape[1:])
    out = {}
    levels = jax.jit(lambda q: pyramid.build_pyramid(q, [(l.h, l.w) for l in lays]))(
        jnp.asarray(quals))
    for i, (lay, q) in enumerate(zip(lays, levels)):
        out[f"q{i}"] = np.asarray(q)
        if not lay.active:
            continue

        def one(ql, lay=lay):
            w = extractor._cell_quality_weights(ql, lay)
            b = jnp.maximum(1.0, jnp.ceil(lay.n_desired * w / jnp.sum(w))).astype(jnp.int32)
            return w, b

        w, b = jax.jit(jax.vmap(one))(q)
        out[f"w{i}"], out[f"b{i}"] = np.asarray(w), np.asarray(b)
    return out


def _task_select(imgs, quals, n_features, n_levels, ini, min_):
    """The reference's _select_level_keypoints on the FAST map of every
    level of each image's pyramid, vmapped and jitted, with the cost map's
    pyramid level (q_ keys) and without one (n_ keys): y, x, response and
    valid per level."""
    import jax
    import jax.numpy as jnp

    from iv_slam_tpu.config import ORBConfig
    from iv_slam_tpu.ops import extractor, fast, pyramid

    cfg = ORBConfig(n_features=int(n_features), n_levels=int(n_levels))
    lays = extractor.make_layouts(cfg, *imgs.shape[1:])
    shapes = [(l.h, l.w) for l in lays]
    out = {}
    for i, lay in enumerate(lays):
        if not lay.active:
            continue

        def run(im, q, lay=lay, i=i):
            s = fast.fast_score(pyramid.build_pyramid(im, shapes)[i], int(min_))
            ql = pyramid.build_pyramid(q, shapes)[i]
            return (extractor._select_level_keypoints(s, ql, lay, int(ini)),
                    extractor._select_level_keypoints(s, None, lay, int(ini)))

        wq, nq = jax.jit(jax.vmap(run))(jnp.asarray(imgs), jnp.asarray(quals))
        for pre, res in (("q_", wq), ("n_", nq)):
            for name, v in zip(("y", "x", "resp", "valid"), res):
                out[f"{pre}{name}{i}"] = np.asarray(v)
    return out


def _task_match_stereo(xyL, octL, descL, validL, xyR, octR, descR, validR,
                       canvasL, canvasR, offsets, widths, scales, bf, min_z):
    """ops/stereo.py match_stereo (jitted), XLA SAD branch."""
    import jax.numpy as jnp

    from iv_slam_tpu.ops import stereo

    a = [jnp.asarray(v) for v in (xyL, octL, descL, validL, xyR, octR, descR,
                                  validR, canvasL, canvasR, offsets, widths, scales)]
    u, d = stereo.match_stereo(*a, jnp.float32(bf), jnp.float32(min_z),
                               use_pallas_sad=False)
    return {"u_right": np.asarray(u), "depth": np.asarray(d)}


def _task_frontend(left, right, cam, n_features, n_levels, max_keypoints, cost_map=None):
    """StereoFrontend.process on one pair (weighted by the uint8 cost map
    when given), plus the (N, 7) host pack of its jitted frame step."""
    import jax.numpy as jnp

    from iv_slam_tpu.config import CameraConfig, Config, ORBConfig
    from iv_slam_tpu.slam.frame import StereoFrontend

    fx, fy, cx, cy, bf, w, h = [float(v) for v in cam]
    cfg = Config()
    cfg.camera = CameraConfig(fx=fx, fy=fy, cx=cx, cy=cy, bf=bf,
                              width=int(w), height=int(h))
    cfg.orb = ORBConfig(n_features=int(n_features), n_levels=int(n_levels),
                        max_keypoints=int(max_keypoints))
    fe = StereoFrontend(cfg, int(h), int(w))
    fr = fe.process(left, right, 0.0, cost_map=cost_map)
    out = {f: np.asarray(getattr(fr.kp, f)) for f in KP_FIELDS}
    out.update(u_right=fr.u_right, depth=fr.depth, qual_score=fr.qual_score,
               fr_xy=fr.xy, fr_octave=fr.octave, fr_valid=fr.valid)
    if cost_map is not None:
        handle = fe._jit_qual(jnp.asarray(left), jnp.asarray(right), jnp.asarray(cost_map))
    else:
        handle = fe._jit_plain(jnp.asarray(left), jnp.asarray(right))
    out["host_pack"] = np.asarray(handle[-1])
    return out


def _task_pose_opt(T0, Xw, obs, inv_sigma2, qual, valid, K, n_rounds, n_iters):
    """pose_optimization (jitted) on one problem, and one robust LM round
    (``_lm_round``, jitted) from T0 over all valid edges; K is
    (fx, fy, cx, cy, bf)."""
    import jax
    import jax.numpy as jnp

    from iv_slam_tpu.geometry import camera
    from iv_slam_tpu.solvers import pose_opt

    Kj = camera.Intrinsics(*(jnp.float32(v) for v in K))
    a = [jnp.asarray(v) for v in (T0, Xw, obs, inv_sigma2, qual, valid)]
    res = pose_opt.pose_optimization(*a, Kj, n_rounds=int(n_rounds), n_iters=int(n_iters))
    is_stereo = a[2][:, 2] >= 0
    delta_sq = jnp.where(is_stereo, pose_opt.DELTA_STEREO_SQ, pose_opt.DELTA_MONO_SQ) \
        * a[4] * a[4]
    T_round = jax.jit(pose_opt._lm_round, static_argnums=(8, 9))(
        a[0], a[1], a[2], a[3], delta_sq, is_stereo, a[5], Kj, True, int(n_iters))
    return {"T": np.asarray(res.T), "inlier": np.asarray(res.inlier),
            "chi2": np.asarray(res.chi2), "n_inliers": np.asarray(res.n_inliers),
            "T_round": np.asarray(T_round)}


STEP_INPUTS = ("cur_xy", "cur_oct", "cur_angle", "cur_desc", "cur_ur", "cur_valid",
               "cur_qual", "cur_depth", "last_xy", "last_oct", "last_angle",
               "last_valid", "last_pt_ids", "T_pred", "T_last", "map_pos", "map_desc",
               "map_normal", "map_mind", "map_maxd", "map_qual", "map_valid")
RESULT_FIELDS = ("T", "assign_map", "inlier", "chi2", "n_motion", "n_final")


def _tracking_config(cam, n_features, n_levels):
    """A JAX-package Config from cam = (fx, fy, cx, cy, bf, width, height)."""
    from iv_slam_tpu.config import CameraConfig, Config, ORBConfig

    fx, fy, cx, cy, bf, w, h = [float(v) for v in cam]
    cfg = Config()
    cfg.camera = CameraConfig(fx=fx, fy=fy, cx=cx, cy=cy, bf=bf, width=int(w),
                              height=int(h))
    cfg.orb = ORBConfig(n_features=int(n_features), n_levels=int(n_levels))
    return cfg


def _result(res, flat):
    out = {f: np.asarray(getattr(res, f)) for f in RESULT_FIELDS}
    out["flat"] = np.asarray(flat)
    return out


def _task_fused_step(cam, n_features, n_levels, **inputs):
    """FusedTracker._step (jitted) on each case of the given frame,
    last-frame and map arrays (stacked on a leading case axis, one shape:
    one compile); the results come back stacked the same way."""
    import jax.numpy as jnp

    from iv_slam_tpu.slam.fused_track import FusedTracker

    cfg = _tracking_config(cam, n_features, n_levels)
    tr = FusedTracker(cfg, cfg.camera.height, cfg.camera.width)
    outs = [_result(*tr._step(*(jnp.asarray(inputs[k][i]) for k in STEP_INPUTS)))
            for i in range(len(inputs["T_pred"]))]
    return {k: np.stack([o[k] for o in outs]) for k in outs[0]}


def init_map(m, frame, cam, propagate_keyptqual=False):
    """A map from one stereo frame at the identity pose, through the MapStore
    calls of Tracking._stereo_initialization (tracking.py:677-695); works on
    the JAX package's MapStore and Frame and on the port's."""
    frame.set_pose(np.eye(4, dtype=np.float32))
    kf = m.add_keyframe(frame)
    for i in np.nonzero(frame.valid & (frame.depth > 0))[0]:
        pos = frame.unproject_stereo(i, cam.fx, cam.fy, cam.cx, cam.cy)
        pid = m.add_point(pos, kf, frame.qual_score[i] if propagate_keyptqual else 1.0)
        m.add_observation(pid, kf, int(i))
        frame.map_pt[i] = pid
        m.compute_distinctive_descriptor(pid)
        m.update_normal_and_depth(pid)
    return kf


def _task_fused_slice(left0, right0, left1, right1, cam, n_features, n_levels):
    """The slice as a whole on the JAX package: StereoFrontend on two pairs,
    a map from frame 0 (MapStore, DeviceMap.sync), then FusedTracker.track
    of frame 1 against frame 0 at T_pred = frame 0's pose."""
    from iv_slam_tpu.slam.device_map import DeviceMap
    from iv_slam_tpu.slam.frame import StereoFrontend
    from iv_slam_tpu.slam.fused_track import FusedTracker
    from iv_slam_tpu.slam.map_store import MapStore

    cfg = _tracking_config(cam, n_features, n_levels)
    h, w = cfg.camera.height, cfg.camera.width
    fe = StereoFrontend(cfg, h, w)
    f0 = fe.process(left0, right0, 0.0)
    f1 = fe.process(left1, right1, 0.1)
    m = MapStore(n_levels=cfg.orb.n_levels, scale_factor=cfg.orb.scale_factor)
    init_map(m, f0, cfg.camera)
    dmap = DeviceMap()
    dmap.sync(m)
    res, flat = FusedTracker(cfg, h, w).track(f1, f0, f0.map_pt, f0.pose, dmap)
    out = _result(res, flat)
    out.update(map_pt0=f0.map_pt, n_points=np.int32(m.n_points),
               **{"map_" + f: np.asarray(v) for f, v in zip(
                   ("pos", "desc", "normal", "mind", "maxd", "qual", "valid"),
                   dmap.live_views())})
    return out



# ---- keyframe event (ROADMAP A5-A6) ----------------------------------------

def _task_log(x):
    """jnp.log (jitted) in float32."""
    import jax
    import jax.numpy as jnp

    return {"log": np.asarray(jax.jit(jnp.log)(jnp.asarray(x)))}


FUSE_KF = ("kf_xy", "kf_oct", "kf_desc", "kf_valid", "kf_ur", "kf_T")
FUSE_PT = ("pt_pos", "pt_desc", "pt_normal", "pt_mind", "pt_maxd", "pt_mask_nb")
FUSE_MAP = ("map_pos", "map_desc", "map_normal", "map_mind", "map_maxd", "map_valid")
FUSE_TAIL = ("sf", "log_scale", "fx", "fy", "cx", "cy", "width", "height", "bf",
             "radius_th")


def _task_fuse(n_cases, **a):
    """fuse_into_keyframes (dense), _compact and _compact_indexed (jitted) on
    each case c: its arrays are the inputs named c<c>_<name>, and
    c<c>_scw the static flag."""
    import jax.numpy as jnp

    from iv_slam_tpu.ops import match

    out = {}
    for c in range(int(n_cases)):
        j = {k[len(f"c{c}_"):]: jnp.asarray(v) for k, v in a.items()
             if k.startswith(f"c{c}_")}
        kf = tuple(j[k] for k in FUSE_KF)
        tail = tuple(j[k] for k in FUSE_TAIL)
        scw = bool(j["scw"])
        out[f"c{c}_dense"] = np.asarray(match.fuse_into_keyframes(
            *kf, *(j[k] for k in FUSE_PT), *tail, scw=scw))
        out[f"c{c}_compact"] = np.asarray(match.fuse_into_keyframes_compact(
            *kf, *(j[k] for k in FUSE_PT), *tail, scw=scw))
        out[f"c{c}_indexed"] = np.asarray(match.fuse_into_keyframes_compact_indexed(
            *kf, j["kf_ok"], *(j[k] for k in FUSE_MAP), j["pid_idx"], *tail, scw=scw))
    return out


TRI_EVENT_INPUTS = ("xy1", "desc1", "free1", "ur1", "depth1", "oct1", "xy2_nb", "desc2_nb",
                    "free2_nb", "ur2_nb", "depth2_nb", "oct2_nb", "F12_nb", "epipole2_nb",
                    "ex_check_nb", "T1w", "T2w_nb", "sf", "fx", "fy", "cx", "cy", "bf")
TRI_PAIR_INPUTS = ("xy1", "xy2", "ur1", "depth1", "ur2", "depth2", "sigma2_1", "sigma2_2",
                   "scale1", "scale2", "valid", "T1w", "T2w", "fx", "fy", "cx", "cy", "bf")


def _task_triangulate(**a):
    """triangulate_checked (jitted) on the pair inputs, and
    triangulate_event_compact (jitted) on each stacked event case."""
    import jax.numpy as jnp

    from iv_slam_tpu.ops import triangulate as tri

    X, good = tri.triangulate_checked(*(jnp.asarray(a["pair_" + k]) for k in TRI_PAIR_INPUTS))
    events = [np.asarray(tri.triangulate_event_compact(
        *(jnp.asarray(a["ev_" + k][i]) for k in TRI_EVENT_INPUTS)))
        for i in range(len(a["ev_T1w"]))]
    return {"X": np.asarray(X), "good": np.asarray(good),
            "events": np.stack(events)}


BA_FIELDS = ("kf_pose", "kf_fixed", "pt_pos", "pt_valid", "e_kf", "e_pt", "e_obs",
             "e_inv_s2", "e_qual", "e_valid")


def _task_ba(K, n_iters1, n_iters2, **a):
    """ba_solve (jitted) on each stacked problem (one shape: one compile)."""
    import jax.numpy as jnp

    from iv_slam_tpu.geometry import camera
    from iv_slam_tpu.solvers.ba_core import BAProblem, ba_solve

    Kj = camera.Intrinsics(*(jnp.float32(v) for v in K))
    outs = []
    for i in range(len(a["kf_pose"])):
        prob = BAProblem(*(jnp.asarray(a[f][i]) for f in BA_FIELDS))
        res = ba_solve(prob, Kj, n_iters1=int(n_iters1), n_iters2=int(n_iters2))
        outs.append({f: np.asarray(getattr(res, f)) for f in res._fields})
    return {k: np.stack([o[k] for o in outs]) for k in outs[0]}


def _task_ba_segments(K, **a):
    """The JAX segmented solver on one problem: ba_segment over the async
    local BA's plan (phase 1 = 3 + 2 robust iterations, the midpoint gate,
    phase 2 = 4 + 3 + 3 iterations without the kernel), each cut's state
    (seg<i>_kf/_pt/_lam/_ni/_chi, mid_mask), ba_finalize of the last
    (fin_<field>), and the whole driver (drv_<field>)."""
    import jax.numpy as jnp

    from iv_slam_tpu.geometry import camera
    from iv_slam_tpu.solvers import local_ba
    from iv_slam_tpu.solvers.ba_core import BAProblem, ba_finalize, ba_midpoint, ba_segment

    Kj = camera.Intrinsics(*(jnp.float32(v) for v in K))
    prob = BAProblem(*(jnp.asarray(a[f]) for f in BA_FIELDS))
    out = {}
    kf, pt = prob.kf_pose, prob.pt_pos
    lam, ni, chi = jnp.float32(0.0), jnp.float32(2.0), jnp.float32(0.0)
    mask = prob.e_valid
    i = 0
    for phase, segs in enumerate(local_ba.BA_SEGMENTS):
        if phase == 1:
            mask = ba_midpoint(prob, Kj, kf, pt)
            out["mid_mask"] = np.asarray(mask)
        for j, n in enumerate(segs):
            kf, pt, lam, ni, chi = ba_segment(prob, Kj, kf, pt, lam, ni, chi, mask,
                                              n_iters=n, kernel_on=phase == 0, init=j == 0)
            out.update({f"seg{i}_kf": np.asarray(kf), f"seg{i}_pt": np.asarray(pt),
                        f"seg{i}_lam": np.asarray(lam), f"seg{i}_ni": np.asarray(ni),
                        f"seg{i}_chi": np.asarray(chi)})
            i += 1
    fin = ba_finalize(prob, Kj, kf, pt)
    drv = local_ba._ba_solve_segmented_driver(BAProblem(*(a[f] for f in BA_FIELDS)), Kj)()
    for f in fin._fields:
        out["fin_" + f] = np.asarray(getattr(fin, f))
        out["drv_" + f] = np.asarray(getattr(drv, f))
    return out


def dump_map(m, recent_points=None):
    """A MapStore (the JAX package's or the port's) as flat numpy arrays:
    point and keyframe tables, the observation dicts in insertion order and
    the keyframes' frames; recent_points likewise. Copies, never views of
    the live tables."""
    n, k = m.n_points, m.n_keyframes
    out = {f: np.array(getattr(m, f)[:n]) for f in (
        "pt_pos", "pt_desc", "pt_normal", "pt_min_dist", "pt_max_dist", "pt_alive",
        "pt_quality", "pt_visible", "pt_found", "pt_first_kf", "pt_ref_kf", "pt_n_obs")}
    out.update({f: np.array(getattr(m, f)[:k]) for f in (
        "kf_pose", "kf_alive", "kf_frame_id", "kf_timestamp")})
    obs = [(p, kf, f) for p in range(n) for kf, f in m.pt_obs[p].items()]
    out["obs"] = np.array(obs, np.int64).reshape(-1, 3)
    out["origin_kf"] = np.int64(m.origin_kf)
    frames = [m.kf_frames[i] for i in range(k)]
    for f in ("xy", "octave", "angle", "desc", "valid", "u_right", "depth", "qual_score",
              "map_pt"):
        out["fr_" + f] = np.stack([np.asarray(getattr(fr, f)) for fr in frames])
    if recent_points is not None:
        out["recent"] = np.array(list(recent_points.items()), np.int64).reshape(-1, 2)
    return out


def _task_keyframe_event(seed, n_frames, event, kf_every, cam, n_features, n_levels,
                         vis_ba_px=0.0, constrained=False):
    """The JAX package's System over a synth_world sequence with a keyframe
    forced every kf_every frames (tests/test_ba_variants.py's loop); the map
    just before and just after LocalMapping._process_one of event number
    `event` (0 = the initialization's). With vis_ba_px > 0, then the map
    with every keyframe's keypoint positions (the BA's observations) moved
    by seeded Gaussian noise of that many pixels, before and after one
    local_bundle_adjustment_vis at the same keyframe (vis_ keys). With
    `constrained`, then every keyframe's ground-truth pose set and the map
    before and after one constrained_local_bundle_adjustment at the same
    keyframe (con_ keys, con_gt_pose). The run stops there."""
    import synth_world

    from iv_slam_tpu.slam import local_mapping
    from iv_slam_tpu.slam.system import System
    from iv_slam_tpu.solvers import local_ba

    cfg = _tracking_config(cam, n_features, n_levels)
    world, frames, gt = synth_world.make_sequence(np.random.default_rng(int(seed)),
                                                  n_frames=int(n_frames), step=0.08)
    orig = local_mapping.LocalMapping._process_one
    px = float(vis_ba_px)
    constrained = bool(constrained)
    seen, out = [], {}

    def process(self, kf_id, run_ba=True):
        if len(seen) == int(event):
            out.update({"before_" + k: v for k, v in
                        dump_map(self.map, self.recent_points).items()})
            out.update(kf_id=np.int64(kf_id), run_ba=np.bool_(run_ba))
        orig(self, kf_id, run_ba)
        if len(seen) == int(event):
            out.update({"after_" + k: v for k, v in
                        dump_map(self.map, self.recent_points).items()})
            if px > 0:
                m = self.map
                r = np.random.default_rng(0)
                for k in range(m.n_keyframes):
                    fr = m.kf_frames[k]
                    fr.xy = (fr.xy + r.normal(0, px, fr.xy.shape)).astype(np.float32)
                out.update({"vis_before_" + k: v for k, v in dump_map(m).items()})
                local_ba.local_bundle_adjustment_vis(self.cfg, m, kf_id)
                out.update({"vis_after_" + k: v for k, v in dump_map(m).items()})
            if constrained:
                # every keyframe's ground truth relative to the first
                # camera (the map's frame, as KITTI's poses are), then one
                # constrained BA at the same keyframe (on the noisy map when
                # vis_ba_px > 0)
                m = self.map
                for k in range(m.n_keyframes):
                    m.kf_gt_pose[k] = (np.linalg.inv(gt[0])
                                       @ gt[int(m.kf_frame_id[k])]).astype(np.float32)
                out["con_gt_pose"] = np.stack(m.kf_gt_pose[:m.n_keyframes])
                out.update({"con_before_" + k: v for k, v in dump_map(m).items()})
                local_ba.constrained_local_bundle_adjustment(self.cfg, m, kf_id)
                out.update({"con_after_" + k: v for k, v in dump_map(m).items()})
        seen.append(kf_id)

    local_mapping.LocalMapping._process_one = process
    s = System(cfg, cfg.camera.height, cfg.camera.width)
    tr = s.tracking
    for i, (left, right) in enumerate(frames):
        s.track_stereo(left, right, timestamp=i * 0.1)
        if i % int(kf_every) == int(kf_every) - 1 and tr.current.frame_id != tr.last_kf_frame_id:
            tr._create_new_keyframe()
        if "after_obs" in out:
            break
    assert "after_obs" in out, f"only {len(seen)} keyframe events"
    return out


def jax_vocabulary(voc):
    """The JAX package's Vocabulary from arrays voc_<field> (children,
    node_desc, weights, is_leaf, k, L)."""
    from iv_slam_tpu.slam.vocabulary import Vocabulary

    return Vocabulary(voc["voc_children"], voc["voc_node_desc"], voc["voc_weights"],
                      voc["voc_is_leaf"].astype(bool), int(voc["voc_k"]), int(voc["voc_L"]))


def vocabulary_arrays(voc):
    """voc_<field> arrays of a Vocabulary (either package's)."""
    return {f"voc_{f}": np.asarray(getattr(voc, f)) for f in
            ("children", "node_desc", "weights", "is_leaf", "k", "L")}


def _task_system(seed, n_frames, kf_every, cam, n_features, n_levels, cost_map=None, **voc):
    """The JAX package's System over a synth_world sequence, a keyframe
    forced every kf_every frames (0: none), classic then fused tracking,
    then (with `cost_map`) fused tracking with every frame weighted by the
    cost map and local BA in the vis mode, then (with a vocabulary,
    voc_<field>) fused tracking with use_bow and loop closing on, then
    fused tracking through the LocalMapping worker with each event waited
    for (serialize_worker): each run's trajectory, map size and point
    qualities, prefixed classic_ / fused_ / iv_ / lc_ / thr_ (with the
    loops closed and the keyframe database's keyframes; with the keyframes'
    timestamps)."""
    import synth_world

    from iv_slam_tpu.slam.system import System

    world, frames, gt = synth_world.make_sequence(np.random.default_rng(int(seed)),
                                                  n_frames=int(n_frames), step=0.08)
    out = {}
    names = (("classic", "fused") + (("iv",) if cost_map is not None else ())
             + (("lc",) if voc else ()) + ("thr",))
    for name in names:
        cfg = _tracking_config(cam, n_features, n_levels)
        cfg.system.fused_tracking = name != "classic"
        cost = cost_map if name == "iv" else None
        if name == "iv":
            cfg.iv.ba_mode = "vis"
        if name == "lc":
            cfg.system.use_bow = cfg.system.enable_loop_closing = True
        if name == "thr":
            cfg.system.threaded_local_mapping = True
        s = System(cfg, cfg.camera.height, cfg.camera.width)
        if name == "lc":
            s.attach_vocabulary(jax_vocabulary(voc))
        tr = s.tracking
        if name == "thr":
            serialize_worker(tr.local_mapping)
        k = int(kf_every)
        for i, (left, right) in enumerate(frames):
            s.track_stereo(left, right, timestamp=i * 0.1, cost_map=cost)
            if k and i % k == k - 1 and tr.current.frame_id != tr.last_kf_frame_id:
                tr._create_new_keyframe()
        m = tr.map
        out.update({f"{name}_twc": np.stack(s.trajectory_twc()),
                    f"{name}_failures": np.int64(s.failure_count),
                    f"{name}_n_keyframes": np.int64(m.n_keyframes),
                    f"{name}_n_points": np.int64(m.n_points),
                    f"{name}_n_alive": np.int64(m.pt_alive[:m.n_points].sum()),
                    f"{name}_pt_quality": np.array(m.pt_quality[:m.n_points])})
        if name == "lc":
            out.update(lc_n_loops=np.int64(tr.loop_closing.n_loops_closed),
                       lc_kfdb=np.array(list(tr.kfdb.bow), np.int64))
        if name == "thr":
            out["thr_kf_timestamp"] = np.array(m.kf_timestamp[:m.n_keyframes])
            s.shutdown()
    return out


def serialize_worker(lm):
    """Make a LocalMapping worker (either package's) deterministic: each
    kick_async waits until the worker has run the events it handed over,
    so a threaded run takes the inline run's steps in the inline order."""
    kick = lm.kick_async

    def kick_and_wait(run_ba=True):
        kick(run_ba=run_ba)
        lm._q.join()

    lm.kick_async = kick_and_wait


# ---- mono and RGB-D, training-data generation (ROADMAP A9, A12) ------------

def mono_rgbd_world(n_frames, seed=23):
    """tests/test_mono_rgbd.py's world and path: a TwoPlaneWorld (320x240,
    fx = fy = 400) seen from 10 m, 0.25 m a frame with a sway and a slow
    yaw. Returns (images, depth maps, Twc ground truth)."""
    import synth_world

    world = synth_world.TwoPlaneWorld(np.random.default_rng(seed))
    gt = [synth_world.camera_pose(np.array([i * 0.25, 0.03 * np.sin(i * 0.5), 0.0], np.float32),
                                  height=10.0, yaw=0.01 * i) for i in range(n_frames)]
    return (np.stack([world.render(T) for T in gt]),
            np.stack([world.render_depth(T) for T in gt]), np.stack(gt))


def _task_mono_frontend(img, cost_map, depth_f, depth_u16, cam, n_features, n_levels):
    """MonoFrontend.process of one image without and with a cost map (mono_
    and monoq_ keys), and RGBDFrontend.process of it with a float depth map
    in metres (rgbdf_ keys) and a uint16 one at 1/5000 (rgbdu_ keys): every
    Frame field."""
    from iv_slam_tpu.slam.frame import MonoFrontend, RGBDFrontend

    cfg = _tracking_config(cam, n_features, n_levels)
    h, w = cfg.camera.height, cfg.camera.width
    mono = MonoFrontend(cfg, h, w)
    rgbd = RGBDFrontend(cfg, h, w)
    frames = {"mono": mono.process(img, 0.0), "monoq": mono.process(img, 0.1, cost_map),
              "rgbdf": rgbd.process(img, depth_f, 0.0, 1.0),
              "rgbdu": rgbd.process(img, depth_u16, 0.1, 1.0 / 5000.0)}
    out = {}
    for name, fr in frames.items():
        out.update({f"{name}_{f}": np.asarray(getattr(fr.kp, f)) for f in KP_FIELDS})
        out.update({f"{name}_{f}": np.asarray(getattr(fr, f)) for f in (
            "u_right", "depth", "qual_score", "xy", "octave", "valid", "frame_id")})
    return out


def _task_mono_rgbd_system(imgs, depths, cam, n_features, n_levels, fused, kf_every_rgbd):
    """The JAX package's System over the frames with track_mono (mono_ keys)
    and with track_rgbd (rgbd_ keys, a keyframe forced every kf_every_rgbd
    frames, 0: none): each frame's state, the trajectory, the map's size,
    its keyframes' frame ids, and the last frame's associations and pose-LM
    chi2 record."""
    from iv_slam_tpu.slam.system import System

    out = {}
    for sensor in ("mono", "rgbd"):
        cfg = _tracking_config(cam, n_features, n_levels)
        cfg.system.sensor = sensor
        cfg.system.fused_tracking = bool(fused)
        s = System(cfg, cfg.camera.height, cfg.camera.width)
        states = []
        for i, img in enumerate(imgs):
            if sensor == "mono":
                s.track_mono(img, i * 0.1)
            else:
                s.track_rgbd(img, depths[i], i * 0.1)
                force_keyframe(s.tracking, i, int(kf_every_rgbd))
            states.append(s.state.value)
        tr = s.tracking
        m = tr.map
        res = {"states": np.array(states), "twc": np.stack(s.trajectory_twc()),
               "n_keyframes": np.int64(m.n_keyframes), "n_points": np.int64(m.n_points),
               "n_alive": np.int64(m.pt_alive[:m.n_points].sum()),
               "kf_frame_id": np.array(m.kf_frame_id[:m.n_keyframes]),
               "chi2": np.asarray(tr.current.chi2), "chi2_dof": np.asarray(tr.current.chi2_dof),
               "map_pt": np.array(tr.current.map_pt)}
        out.update({f"{sensor}_{k}": v for k, v in res.items()})
    return out


def _task_mono_rgbd(img, cost_map, depth_f, depth_u16, imgs, depths, cam, n_features,
                    n_levels, fused, kf_every_rgbd):
    """_task_mono_frontend and _task_mono_rgbd_system in one process."""
    out = _task_mono_frontend(img, cost_map, depth_f, depth_u16, cam, n_features, n_levels)
    out.update(_task_mono_rgbd_system(imgs, depths, cam, n_features, n_levels, fused,
                                      kf_every_rgbd))
    return out


def force_keyframe(tr, i, kf_every):
    """A keyframe at frame i when i closes a group of kf_every frames (0:
    never) and the frame tracks and is not one already (either package's
    Tracking). The frame's trajectory entry, recorded against the previous
    reference keyframe, is then recorded again against the new one, as the
    tracker records a frame after its own keyframe decision: the next
    frame's motion model starts from that entry."""
    if (kf_every and i % kf_every == kf_every - 1 and tr.state.value == 2
            and tr.current.frame_id != tr.last_kf_frame_id):
        tr._create_new_keyframe()
        fr = tr.current
        tr.rel_poses[-1] = (fr.pose @ np.linalg.inv(tr.map.kf_pose[tr.ref_kf])).astype(
            np.float32)
        tr.rel_refs[-1] = tr.ref_kf


def frame_arrays(fr, pre):
    """The fields of a Frame (either package's) the data generator reads."""
    out = {pre + f: np.asarray(getattr(fr, f)) for f in (
        "xy", "octave", "valid", "u_right", "depth", "map_pt", "pose", "gt_pose", "desc",
        "angle")}
    out[pre + "img_name"] = np.array(fr.img_name)
    out[pre + "frame_id"] = np.int64(fr.frame_id)
    out[pre + "gt_depth"] = (np.asarray(fr.kp_gt_depth) if fr.kp_gt_depth is not None
                             else np.full(len(fr.xy), -1.0, np.float32))
    return out


SUPERVISED_MODES = ("prev_frame", "prev_frame_and_ref_kf", "ref_kf", "prev_frame_epipolar",
                    "ref_kf_epipolar", "prev_frame_epipolar_normalized",
                    "ref_kf_epipolar_normalized")


def _task_datagen(imgs_l, imgs_r, depths, gt, cam, n_features, n_levels, max_train_points,
                  record_frame, map_path):
    """The JAX package's System tracking stereo frames with GT poses and GT
    depth maps and supervised training-data generation on (no files). At
    frame `record_frame` its map is saved to map_path just before
    process_frame_supervised, with the frame, the previous frame and every
    keyframe's GT poses and depths; then that call runs in each implemented
    training mode (<mode>_ keys: the result's arrays and numbers), and
    process_frame_unsupervised on the frame's pose-LM chi2 record (unsup_
    keys, its inputs and result). The run stops there."""
    from iv_slam_tpu.introspection import datagen
    from iv_slam_tpu.slam.system import System

    cfg = _tracking_config(cam, n_features, n_levels)
    cfg.iv.enabled = True
    cfg.gp.max_train_points = int(max_train_points)
    s = System(cfg, cfg.camera.height, cfg.camera.width)
    s.enable_datagen(None)
    orig = datagen.DataGenerator.process_frame_supervised
    out = {}

    def record(self, frame, img_hw, prev_frame=None):
        if frame.frame_id == int(record_frame) and not out:
            m = self.map
            m.save(str(map_path))
            out.update(frame_arrays(frame, "cur_"))
            out.update(frame_arrays(prev_frame, "prev_"))
            out["kf_gt_depth"] = np.stack([
                np.asarray(m.kf_frames[k].kp_gt_depth) for k in range(m.n_keyframes)])
            out["kf_gt_pose"] = np.stack([m.kf_gt_pose[k] for k in range(m.n_keyframes)])
            for mode in SUPERVISED_MODES:
                cfg.iv.training_mode = mode
                r = orig(self, frame, img_hw, prev_frame)
                out[mode + "_none"] = np.bool_(r is None)
                if r is not None:
                    for k in ("heatmap", "norm_err", "keep", "good", "bad_percent",
                              "n_scored"):
                        out[f"{mode}_{k}"] = np.asarray(r[k])
            cfg.iv.training_mode = "ref_kf_epipolar_normalized"
            found = np.where(frame.map_pt >= 0, m.pt_found[np.maximum(frame.map_pt, 0)], 0)
            r = self.process_frame_unsupervised(frame, frame.chi2, frame.chi2_dof, found,
                                                True, img_hw)
            out.update(unsup_chi2=np.asarray(frame.chi2), unsup_dof=np.asarray(frame.chi2_dof),
                       unsup_found=found, unsup_heatmap=r["heatmap"], unsup_mask=r["mask"],
                       unsup_qual=r["qual"], unsup_good=np.bool_(r["good"]))
        return orig(self, frame, img_hw, prev_frame)

    datagen.DataGenerator.process_frame_supervised = record
    for i in range(len(imgs_l)):
        s.track_stereo(imgs_l[i], imgs_r[i], i * 0.1, gt_pose=gt[i], img_name=f"{i:06d}.png",
                       gt_depth_map=depths[i])
        if out:
            break
    assert out, "the frame was not recorded"
    return out


# ---- BoW, relocalization and loop closing (ROADMAP A8, A10) ---------------

BOW_INPUTS = ("desc_a", "node_a", "angle_a", "valid_a", "desc_b", "node_b", "angle_b",
              "valid_b", "nn_ratio")
SIM3_INPUTS = ("P1", "desc1", "xy1", "oct1", "valid1", "P2", "desc2", "xy2", "oct2", "valid2",
               "sR12", "t12", "fx", "fy", "cx", "cy", "sf", "log_scale", "maxd1", "maxd2")


def _task_bow_match(n_bow, n_sim3, **a):
    """search_by_bow (jitted, with and without the orientation check) on
    each case bow<c>_<name>, search_by_sim3 (jitted) on each sim3<c>_<name>."""
    import jax.numpy as jnp

    from iv_slam_tpu.ops import bow_match

    out = {}
    for c in range(int(n_bow)):
        args = [jnp.asarray(a[f"bow{c}_{k}"]) for k in BOW_INPUTS]
        for chk in (True, False):
            assign, n = bow_match.search_by_bow(*args, check_orientation=chk)
            out[f"bow{c}_{int(chk)}"] = np.asarray(assign)
    for c in range(int(n_sim3)):
        assign, n = bow_match.search_by_sim3(*(jnp.asarray(a[f"sim3{c}_{k}"])
                                               for k in SIM3_INPUTS))
        out[f"sim3{c}"] = np.asarray(assign)
    return out


def jax_sim3_indices(key_id, n_hyp, n_valid, device=None):
    """The (n_hyp, 3) hypothesis indices the JAX package's sim3_ransac draws
    under PRNGKey(key_id) from the valid prefix [0, n_valid) (a sampler for
    LoopClosing.sampler)."""
    import jax
    import torch

    idx = jax.random.randint(jax.random.PRNGKey(int(key_id)), (n_hyp, 3), 0,
                             max(int(n_valid), 1))
    return torch.as_tensor(np.array(idx), dtype=torch.int64, device=device)


def jax_pnp_indices(key_id, valid, device=None, n_hyp=300, sample_size=4):
    """The (n_hyp, sample_size) indices the JAX package's pnp_ransac draws
    under PRNGKey(key_id) over the valid entries (a sampler for
    Tracking.pnp_sampler)."""
    import jax
    import jax.numpy as jnp
    import torch

    valid = jnp.asarray(np.asarray(valid, bool))
    n = valid.shape[0]
    p = jnp.where(valid, 1.0, 0.0) / jnp.maximum(jnp.sum(valid), 1)

    @jax.jit
    def draw(keys):
        return jax.vmap(lambda k: jax.random.choice(k, n, shape=(sample_size,),
                                                    replace=False, p=p))(keys)

    idx = draw(jax.random.split(jax.random.PRNGKey(int(key_id)), n_hyp))
    return torch.as_tensor(np.array(idx), dtype=torch.int64, device=device)


def bow_session(s, frames, kf_every, loc_from, bow_frame, reloc_frame):
    """Drive a System (either package's) with a vocabulary attached and loop
    closing on over `frames`, a keyframe forced every kf_every frames, in
    localization-only mode from frame loc_from on. Then, by direct calls on
    re-processed frames: tracking by BoW against the reference keyframe
    (frame bow_frame from the last pose) and relocalization (frame
    reloc_frame, the state set to LOST by hand: the reference's loop never
    reaches it). Returns a dict of numpy arrays."""
    tr = s.tracking
    m = tr.map
    out = {}
    for i, (left, right) in enumerate(frames):
        if i == loc_from:
            out.update(loc_kfs=np.int64(m.n_keyframes), loc_pts=np.int64(m.n_points),
                       loc_alive=np.int64(m.pt_alive[:m.n_points].sum()))
            s.activate_localization_mode()
        s.track_stereo(left, right, timestamp=i * 0.1)
        if (kf_every and i % kf_every == kf_every - 1 and not tr.only_tracking
                and tr.current.frame_id != tr.last_kf_frame_id):
            tr._create_new_keyframe()
    s.deactivate_localization_mode()
    lc = tr.loop_closing
    out.update(twc=np.stack(s.trajectory_twc()), failures=np.int64(s.failure_count),
               n_keyframes=np.int64(m.n_keyframes), n_points=np.int64(m.n_points),
               n_alive=np.int64(m.pt_alive[:m.n_points].sum()),
               n_loops=np.int64(lc.n_loops_closed), kfdb=np.array(list(tr.kfdb.bow), np.int64),
               temporal=np.int64(len(tr._temporal_points)))
    last = tr.current
    for name, j in (("bow", int(bow_frame)), ("reloc", int(reloc_frame))):
        tr.last_frame = last
        fr = tr.frontend.process(*frames[j], 10.0 + j)
        tr.current = fr
        if name == "bow":
            fr.set_pose(last.pose)
            ok = tr._track_reference_keyframe_bow()
        else:
            tr.state = type(tr.state).LOST
            ok = tr._relocalization()
            out["reloc_state"] = np.int64(tr.state.value)
        out.update({f"{name}_ok": np.bool_(ok), f"{name}_frame_id": np.int64(fr.frame_id),
                    f"{name}_pose": np.array(fr.pose, np.float32),
                    f"{name}_map_pt": np.array(fr.map_pt)})
    return out


def _task_bow_system(seed, n_frames, kf_every, cam, n_features, n_levels, loc_from, bow_frame,
                     reloc_frame, **voc):
    """bow_session on the JAX package's System (fused tracking, use_bow and
    enable_loop_closing on) over a synth_world sequence, with the
    vocabulary given as arrays (voc_<field>)."""
    import synth_world

    from iv_slam_tpu.slam.system import System

    cfg = _tracking_config(cam, n_features, n_levels)
    cfg.system.fused_tracking = True
    cfg.system.use_bow = cfg.system.enable_loop_closing = True
    world, frames, gt = synth_world.make_sequence(np.random.default_rng(int(seed)),
                                                  n_frames=int(n_frames), step=0.08)
    s = System(cfg, cfg.camera.height, cfg.camera.width)
    s.attach_vocabulary(jax_vocabulary(voc))
    return bow_session(s, frames, int(kf_every), int(loc_from), bow_frame, reloc_frame)


def lc_world(n_frames, radius):
    """bench.py's loop-closing world (_lc_world, bench.py:378-413) on a
    circle of `radius` m: DistinctTerrainWorld (seed 3, its platforms ring
    on the circle), 320x240, fx = fy = 400, baseline 0.5, 1.45 laps with
    the yaw following the path. Returns (stereo pairs, Twc per frame)."""
    import synth_world

    world = synth_world.DistinctTerrainWorld(
        np.random.default_rng(3), ring_center=(0.0, float(radius)), ring_radius=float(radius),
        tex_size=8192, res=60.0, fx=400.0, fy=400.0, cx=160.0, cy=120.0, w=320, h=240,
        baseline=0.5)
    pairs, gt = [], []
    for i in range(int(n_frames)):
        ang = 2.9 * np.pi * i / int(n_frames)
        t = np.array([radius * np.sin(ang), radius * (1 - np.cos(ang)), 0.0], np.float32)
        Twc = synth_world.camera_pose(t, height=10.0, yaw=ang)
        pairs.append(world.render_stereo(Twc))
        gt.append(Twc)
    return pairs, gt


def lc_state(lc):
    """A LoopClosing's state (either package's) as arrays: the keyframe
    database's keyframes in insertion order, the consistent groups, the
    last loop keyframe, the loop edges, the loops closed."""
    groups = lc.consistent_groups
    return dict(kfdb=np.array(list(lc.kfdb.bow), np.int64),
                group_sizes=np.array([len(g) for g, _ in groups], np.int64),
                group_members=np.array([k for g, _ in groups for k in sorted(g)], np.int64),
                group_counts=np.array([c for _, c in groups], np.int64),
                last_loop_kf=np.int64(lc.last_loop_kf),
                loop_edges=np.array(sorted(lc.loop_edges), np.int64).reshape(-1, 2),
                n_loops=np.int64(lc.n_loops_closed))


def _task_lc_event(n_frames, radius, kf_every, n_levels, ba_rate, map_path, **voc):
    """The JAX package's System (fused, use_bow and loop closing on, local BA
    at keyframe events of frames divisible by ba_rate) over lc_world with a
    keyframe forced every kf_every frames, up to the first keyframe event
    whose LoopClosing.process_keyframe closes a loop, with the global BA
    left out (tests/test_torch_loop_closing.py holds it on its own). The
    map just before that call is saved to map_path (MapStore.save); returns
    the keyframe, the LoopClosing state before (before_) and after
    (after_), the map after (dump_map) and the loop fuse's statistics."""
    from iv_slam_tpu.slam import loop_closing
    from iv_slam_tpu.slam.system import System
    from iv_slam_tpu.solvers import local_ba

    cfg = _tracking_config((400.0, 400.0, 160.0, 120.0, 200.0, 320, 240), 800, n_levels)
    cfg.camera.fps = 10.0
    cfg.system.fused_tracking = True
    cfg.system.use_bow = cfg.system.enable_loop_closing = True
    cfg.iv.tracking_ba_rate = int(ba_rate)
    pairs, gt = lc_world(n_frames, float(radius))
    local_ba.global_bundle_adjustment_async = lambda *a, **k: None
    orig = loop_closing.LoopClosing.process_keyframe
    out = {}

    def process(self, kf_id, fix_scale=True):
        if out or self.map.n_keyframes < 11:
            return orig(self, kf_id, fix_scale)
        before = lc_state(self)
        self.map.save(str(map_path))
        closed = orig(self, kf_id, fix_scale)
        if closed:
            out.update(kf_id=np.int64(kf_id), **{"before_" + k: v for k, v in before.items()},
                       **{"after_" + k: v for k, v in lc_state(self).items()},
                       **{"map_" + k: v for k, v in dump_map(self.map).items()},
                       fuse=np.array([self.last_fuse_stats[k] for k in
                                      ("targets", "loop_pts", "replaced", "added")]))
        return closed

    loop_closing.LoopClosing.process_keyframe = process
    s = System(cfg, 240, 320)
    s.attach_vocabulary(jax_vocabulary(voc))
    tr = s.tracking
    k = int(kf_every)
    for i, (left, right) in enumerate(pairs):
        s.track_stereo(left, right, timestamp=i * 0.1)
        if not out and i % k == k - 1 and tr.current.frame_id != tr.last_kf_frame_id:
            tr._create_new_keyframe()
        if out:
            out["frame"] = np.int64(i)
            break
    assert out, "no loop closed"
    return out


def _main(task, src, dst):
    sys.path[:0] = [HERE, os.path.dirname(HERE)]
    import conftest  # noqa: F401  (the tests' JAX-on-CPU settings)

    with np.load(src) as z:
        kwargs = {k: z[k] for k in z.files}
    out = globals()["_task_" + task](**kwargs)
    np.savez(dst, **out)


if __name__ == "__main__":
    _main(*sys.argv[1:4])
