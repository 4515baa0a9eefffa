"""Background warm-up of the tracked session's device work.

Port of ``iv_slam_tpu/slam/prewarm.py``. The reference walks the hot
programs' shape ladder at startup (device_map.py live rungs, local_ba.py
LBA_RUNGS, local_mapping.py fuse/triangulation chunks) so that no compile
lands inside a tracked frame. Eager PyTorch compiles nothing, but a cold
process pays other first-call costs, and the same walk, with the same
rungs and dummy arguments, takes them off the tracking path:

  * the hand kernels' shared libraries (``_kernels.load``: the nvcc build
    when the build directory is cold, then the dlopen);
  * CUDA's lazy module loading of every op the step, the keyframe event,
    the fallbacks and loop closing launch, at each rung's shapes;
  * the cuBLAS and cuSOLVER handles and workspaces (the pose LM, the BA's
    ``solve_ex``, Sim3);
  * the caching allocator's blocks at each rung's sizes.

The walk runs on a daemon thread on the tracking thread's device and
stream (the allocator's pools are per stream: a side stream would warm
blocks that tracking cannot reuse). Its dummy inputs come from seeded
numpy generators: it draws nothing from torch's global RNG or from any
generator of the main path, and it uses a DeviceMap of its own, never the
live one. Two phases, as the reference's: the core (the first two live
rungs, the active triangulation and fuse chunks, the first BA rung), then
``core_ready`` is set, then the tail (the growth rungs, the classic
fallbacks, loop closing). A failure is kept in ``thread.exc``; System's
join and shutdown raise it.
"""

from __future__ import annotations

import threading
from types import SimpleNamespace

import numpy as np
import torch

from .. import _kernels
from ..geometry import camera
from ..ops import match as match_ops
from ..ops import triangulate as tri
from ..utils import argpack


def _dummy_frame_args(N: int, L: int, device):
    """Current/last frame dummy tensors shaped like the frontend's output:
    xy, octave, angle, desc, u_right, valid, quality, depth."""
    rng = np.random.default_rng(0)
    up = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return (up(rng.uniform(0, 300, (N, 2)).astype(np.float32)),
            up(rng.integers(0, L, N).astype(np.int32)),
            up(rng.uniform(0, 360, N).astype(np.float32)),
            up(rng.integers(0, 256, (N, 32)).astype(np.uint8)),
            up(rng.uniform(0, 300, N).astype(np.float32)),
            up(np.ones(N, bool)),
            up(np.ones(N, np.float32)),
            up(rng.uniform(1, 30, N).astype(np.float32)))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _warm_fused_step(tracker, dmap, cfg, N: int, live_rungs):
    """Both step forms at each live rung: ``track``'s (the ids and poses
    riding the packed copy) and ``track_chained``'s (every input on the
    device, the motion model on the device)."""
    dev = tracker.device
    xy, octave, angle, desc, ur, valid, qual, depth = _dummy_frame_args(
        N, cfg.orb.n_levels, dev)
    ids = np.full(N, -1, np.int32)
    T = np.eye(4, dtype=np.float32)
    ids_dev, T_dev = argpack.upload([ids, T], dev)
    for rung in live_rungs:
        views = (dmap.pos[:rung], dmap.desc[:rung], dmap.normal[:rung],
                 dmap.min_dist[:rung], dmap.max_dist[:rung], dmap.quality[:rung],
                 dmap.valid[:rung])
        ids_up, T_up, T_last = argpack.upload([ids, T, T], dev)
        tracker._step(xy, octave, angle, desc, ur, valid, qual, depth,
                      xy, octave, angle, valid, ids_up, T_up, T_last, *views)
        _sync(dev)
        frame = SimpleNamespace(
            kp=SimpleNamespace(xy=xy, octave=octave, angle=angle, desc=desc, valid=valid),
            ur_dev=ur, qual_dev=qual, depth_dev=depth)
        tracker.track_chained(frame, frame, ids_dev, T_dev, T_dev,
                              SimpleNamespace(live_views=lambda: views))
        _sync(dev)


def _warm_splice(dmap, live_rungs):
    """The mirror's full splice at each live rung and its delta scatter at
    each DELTA_RUNGS bucket (on the walk's own DeviceMap)."""
    from .device_map import _scatter, _splice

    dev = dmap.device
    packed, desc, valid = dmap._packed, dmap.desc, dmap.valid
    for rung in live_rungs:
        packed, desc, valid = _splice(
            packed, desc, valid, *argpack.upload(
                [np.zeros((rung, 9), np.float32), np.zeros((rung, 32), np.uint8),
                 np.zeros(rung, bool)], dev))
    for rung in dmap.DELTA_RUNGS:
        idx = torch.full((rung,), dmap.capacity, dtype=torch.int64, device=dev)
        packed, desc, valid = _scatter(
            packed, desc, valid, idx, *argpack.upload(
                [np.zeros((rung, 9), np.float32), np.zeros((rung, 32), np.uint8),
                 np.zeros(rung, bool)], dev))
    _sync(dev)


def _cam_tail(cfg, dev, radius):
    """The fuse's trailing scalars as local_mapping builds them."""
    cam = cfg.camera
    sf = cfg.orb.scale_factors()
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    return (torch.as_tensor(np.asarray(sf, np.float32), device=dev),
            f(np.log(sf[1] / sf[0]) if len(sf) > 1 else 1.0),
            f(cam.fx), f(cam.fy), f(cam.cx), f(cam.cy), f(cam.width), f(cam.height),
            f(cam.bf), f(radius))


def _warm_fuse(cfg, N: int, shapes, dmap):
    """The indexed fuse (the path every fused-mode event takes) at each
    (targets, points) shape, its arguments assembled as
    LocalMapping._fuse_args assembles them: per-frame device tensors
    stacked on the device, the poses, target mask and row indices in one
    packed copy."""
    dev = dmap.device
    rng = np.random.default_rng(1)
    L = cfg.orb.n_levels
    up = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    xy_1 = up(rng.uniform(0, 300, (N, 2)).astype(np.float32))
    oct_1 = up(rng.integers(0, L, N).astype(np.int32))
    desc_1 = up(rng.integers(0, 256, (N, 32)).astype(np.uint8))
    valid_1 = up(np.ones(N, bool))
    ur_1 = up(rng.uniform(0, 300, N).astype(np.float32))
    tail = _cam_tail(cfg, dev, 3.0)
    for nb, p in shapes:
        pid_idx = (np.arange(p) % dmap.capacity).astype(np.int32)
        args = argpack.to_device((
            torch.stack([xy_1] * nb), torch.stack([oct_1] * nb),
            torch.stack([desc_1] * nb), torch.stack([valid_1] * nb),
            torch.stack([ur_1] * nb), np.tile(np.eye(4, dtype=np.float32), (nb, 1, 1)),
            np.ones(nb, bool), *dmap.full_views(), pid_idx, *tail), dev)
        match_ops.fuse_into_keyframes_compact_indexed(*args).cpu()


def _warm_triangulate(cfg, N: int, nb: int, device):
    """One triangulation event at nb neighbours, its arguments assembled
    as LocalMapping._triangulation_args assembles them."""
    cam = cfg.camera
    L = cfg.orb.n_levels
    f32 = np.float32
    rng = np.random.default_rng(2)
    up = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    xy_1 = up(rng.uniform(0, 300, (N, 2)).astype(f32))
    desc_1 = up(rng.integers(0, 256, (N, 32)).astype(np.uint8))
    oct_1 = up(rng.integers(0, L, N).astype(np.int32))
    ur_1 = up(rng.uniform(0, 300, N).astype(f32))
    dep_1 = up(rng.uniform(1, 30, N).astype(f32))
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    args = argpack.to_device((
        xy_1, desc_1, np.ones(N, bool), ur_1, dep_1, oct_1,
        torch.stack([xy_1] * nb), torch.stack([desc_1] * nb), np.ones((nb, N), bool),
        torch.stack([ur_1] * nb), torch.stack([dep_1] * nb), torch.stack([oct_1] * nb),
        rng.normal(0, 1, (nb, 3, 3)).astype(f32), rng.uniform(0, 300, (nb, 2)).astype(f32),
        np.zeros(nb, bool), np.eye(4, dtype=f32), np.tile(np.eye(4, dtype=f32), (nb, 1, 1)),
        torch.as_tensor(np.asarray(cfg.orb.scale_factors(), f32), device=device),
        f(cam.fx), f(cam.fy), f(cam.cx), f(cam.cy), f(cam.bf)), device)
    tri.triangulate_event_compact(*args).cpu()


def _rand_ba_problem(cfg, rng, nk, npt, ne):
    """A random host BAProblem of one rung's shape (points in front of a
    stereo camera, keyframe 0 fixed)."""
    from ..solvers.ba_core import BAProblem

    cam = cfg.camera
    kf_pose = np.tile(np.eye(4, dtype=np.float32), (nk, 1, 1))
    pt = rng.uniform(-10, 10, (npt, 3)).astype(np.float32)
    pt[:, 2] += 20.0
    e_kf = rng.integers(0, nk, ne).astype(np.int32)
    e_pt = rng.integers(0, npt, ne).astype(np.int32)
    X = pt[e_pt]
    u = cam.fx * X[:, 0] / X[:, 2] + cam.cx
    v = cam.fy * X[:, 1] / X[:, 2] + cam.cy
    obs = np.stack([u, v, u - cam.bf / X[:, 2]], 1).astype(np.float32)
    fixed = np.zeros(nk, bool)
    fixed[0] = True
    return BAProblem(kf_pose=kf_pose, kf_fixed=fixed, pt_pos=pt, pt_valid=np.ones(npt, bool),
                     e_kf=e_kf, e_pt=e_pt, e_obs=obs, e_inv_s2=np.ones(ne, np.float32),
                     e_qual=np.ones(ne, np.float32), e_valid=np.ones(ne, bool))


def _warm_local_ba(cfg, rungs, device, segmented: bool = True):
    """The local BA at each rung: the segmented solve (the worker's) or the
    whole solve (inline, the helper thread); both run ba_core's steps."""
    from ..solvers import local_ba

    rng = np.random.default_rng(3)
    K = camera.Intrinsics.from_config(cfg.camera, device)
    for nk, npt, ne in rungs:
        prob = _rand_ba_problem(cfg, rng, nk, npt, ne)
        if segmented:
            res = local_ba._ba_solve_segmented_driver(prob, K)()
        else:
            res = local_ba.ba_solve(local_ba._upload(prob, device), K)
        res.kf_pose.cpu()


def _warm_loop_closing(cfg, N: int, dmap):
    """The loop-closing device work at its call shapes: SearchByBoW, the
    Sim3 RANSAC (256 hypotheses) and refinement, SearchBySim3, the Scw fuse
    tile (16 targets x 4096 points), the first essential-graph bucket and
    the first deferred global-BA rung."""
    from ..ops import bow_match
    from ..solvers import essential_graph as eg
    from ..solvers import local_ba, sim3_opt, sim3_solver

    dev = dmap.device
    cam = cfg.camera
    L = cfg.orb.n_levels
    sf = np.asarray(cfg.orb.scale_factors(), np.float32)
    rng = np.random.default_rng(7)
    f32 = np.float32
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    desc = up(rng.integers(0, 256, (N, 32)).astype(np.uint8))
    nodes = up(rng.integers(0, 64, N).astype(np.int64))
    angle = up(rng.uniform(0, 360, N).astype(f32))
    valid = up(np.ones(N, bool))
    xy = up(rng.uniform(0, 300, (N, 2)).astype(f32))
    octv = up(rng.integers(0, L, N).astype(np.int32))
    P = up(rng.uniform(-4, 4, (N, 3)).astype(f32) + np.array([0, 0, 10], f32))
    sig = up(np.ones(N, f32))
    maxd = up(np.ones(N, f32))

    assign, _ = bow_match.search_by_bow(desc, nodes, angle, valid, desc, nodes, angle,
                                        valid, f(0.75))
    assign.cpu()
    idx = up(rng.integers(0, N, (256, 3)).astype(np.int64))
    res = sim3_solver.sim3_ransac(P, P, xy, xy, sig, valid, cam.fx, cam.fy, cam.cx, cam.cy,
                                  idx, fix_scale=True)
    res.R.cpu()
    assign, _ = bow_match.search_by_sim3(
        P, desc, xy, octv, valid, P, desc, xy, octv, valid,
        up(np.eye(3, dtype=f32)), up(np.zeros(3, f32)), f(cam.fx), f(cam.fy), f(cam.cx),
        f(cam.cy), up(sf), f(np.log(sf[1] / sf[0]) if L > 1 else 1.0), maxd, maxd)
    assign.cpu()
    opt = sim3_opt.optimize_sim3(res.R, res.t, res.s, P, P, xy, xy, sig, sig, valid,
                                 cam.fx, cam.fy, cam.cx, cam.cy, fix_scale=True)
    opt.R.cpu()

    # the Scw fuse tile (loop_closing._search_and_fuse): (16, 4096)
    T_CH, P_CH = 16, 4096
    kf_stack = (torch.stack([xy] * T_CH), torch.stack([octv] * T_CH),
                torch.stack([desc] * T_CH), torch.stack([valid] * T_CH),
                torch.stack([up(rng.uniform(0, 300, N).astype(f32))] * T_CH),
                up(np.tile(np.eye(4, dtype=f32), (T_CH, 1, 1))))
    pts = argpack.upload([rng.uniform(-5, 5, (P_CH, 3)).astype(f32),
                          rng.integers(0, 256, (P_CH, 32)).astype(np.uint8),
                          rng.normal(0, 1, (P_CH, 3)).astype(f32), np.ones(P_CH, f32),
                          np.ones(P_CH, f32), np.ones((T_CH, P_CH), bool)], dev)
    match_ops.fuse_into_keyframes_compact(*kf_stack, *pts, *_cam_tail(cfg, dev, 4.0),
                                          scw=True).cpu()

    # the essential graph's first (K_cap=64, E_cap=512) bucket
    K_cap, E_cap = 64, 512
    fixed = np.zeros(K_cap, bool)
    fixed[0] = True
    prob = eg.EGProblem(*(up(a) for a in (
        np.tile(np.eye(3, dtype=f32), (K_cap, 1, 1)), rng.normal(0, 1, (K_cap, 3)).astype(f32),
        np.ones(K_cap, f32), fixed, (np.arange(E_cap) % (K_cap - 1)).astype(np.int32),
        (np.arange(E_cap) % (K_cap - 1) + 1).astype(np.int32),
        np.tile(np.eye(3, dtype=f32), (E_cap, 1, 1)), np.zeros((E_cap, 3), f32),
        np.ones(E_cap, f32), np.ones(E_cap, bool))))
    R, _t, _s = eg.optimize_essential_graph(prob, fix_scale=True)
    R.cpu()

    # the deferred global BA's first rung, as _dispatch_global_ba solves it
    gba = _rand_ba_problem(cfg, rng, *local_ba.GBA_RUNGS[0])
    res = local_ba.ba_solve(local_ba._upload(gba, dev),
                            camera.Intrinsics.from_config(cam, dev), n_iters1=10,
                            n_iters2=10, kernel2=True, midpoint_gate=False)
    res.kf_pose.cpu()


def _warm_classic_fallbacks(cfg, N: int, device):
    """The fused path's fallbacks: the motion-model search, the pose LM and
    the bucketed local-map search (x4 ladder from 1024 points)."""
    from ..solvers import pose_opt

    cam = cfg.camera
    K = camera.Intrinsics.from_config(cam, device)
    sf = torch.as_tensor(np.asarray(cfg.orb.scale_factors(), np.float32), device=device)
    xy, octave, angle, desc, ur, valid, qual, _depth = _dummy_frame_args(
        N, cfg.orb.n_levels, device)
    T = torch.eye(4, device=device)
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    zeros3 = torch.zeros((N, 3), device=device)
    assign, _ = match_ops.search_by_projection_last_frame(
        xy, octave, angle, desc, ur, valid, zeros3, desc, octave, angle, valid, T, T,
        f(cam.fx), f(cam.fy), f(cam.cx), f(cam.cy), f(cam.bf), f(cam.baseline),
        f(cam.width), f(cam.height), sf, f(7.0))
    assign.cpu()
    res = pose_opt.pose_optimization(
        T, zeros3, torch.cat([xy, ur[:, None]], dim=1), torch.ones(N, device=device), qual,
        valid, K, n_rounds=cfg.iv.optimizer_pose_opt_iter_count)
    res.T.cpu()
    for p in (1024, 4096, 16384):
        assign, _ = match_ops.search_by_projection_local_map(
            xy, octave, desc, ur, valid, valid & False,
            torch.zeros((p, 3), device=device),
            torch.zeros((p, 32), dtype=torch.uint8, device=device),
            torch.zeros((p, 3), device=device), torch.ones(p, device=device),
            torch.ones(p, device=device), torch.ones(p, dtype=torch.bool, device=device), T,
            f(cam.fx), f(cam.fy), f(cam.cx), f(cam.cy), f(cam.bf), f(cam.width),
            f(cam.height), sf, f(np.log(cfg.orb.scale_factor)), f(1.0), f(0.8))
        assign.cpu()


def prewarm_async(tracking, live_rungs=None, fuse_shapes=None,
                  ba_rungs=None) -> threading.Thread:
    """Start the warm-up walk on a daemon thread for a Tracking instance
    (fused path). Returns the thread: ``join()`` it, or wait on
    ``thread.core_ready``; ``thread.exc`` holds the first failure. The
    optional rung lists override the session's (tests)."""
    from ..solvers.local_ba import LBA_RUNGS
    from .device_map import DeviceMap

    cfg = tracking.cfg
    dev = tracking.device
    N = tracking.frontend.extractor.capacity
    # the shared tracker is made on the CALLING thread, so the tracking
    # loop and the walk agree on one instance
    tracking._ensure_fused()
    tracker = tracking._fused
    dmap = DeviceMap(tracking._dmap.capacity, device=dev)   # the walk's own
    if live_rungs is None:
        cap = dmap.capacity
        live_rungs, r = [], 1024
        while r < cap:
            live_rungs.append(r)
            r *= 4
        live_rungs.append(cap)
    lm = tracking.local_mapping
    if fuse_shapes is None:
        # the forward fuse (<= fuse_chunk targets x the frame capacity's
        # points) and the reverse side's point-axis ladder; the chunk is
        # the LocalMapping instance's (the link profile's or the override)
        fuse_shapes = [(1, 2048), (lm.fuse_chunk, 2048), (1, 4096), (1, 8192), (1, 16384)]
    if ba_rungs is None:
        ba_rungs = LBA_RUNGS
    core_live = list(live_rungs[:2]) or list(live_rungs)
    tail_live = list(live_rungs[len(core_live):])
    core_fuse = [s for s in fuse_shapes if s[1] <= 2048]
    tail_fuse = [s for s in fuse_shapes if s[1] > 2048]
    core_ba, tail_ba = list(ba_rungs[:1]), list(ba_rungs[1:])
    segmented = cfg.system.threaded_local_mapping and not lm.monolithic_device
    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None

    def walk_core():
        if dev.type == "cuda":
            _kernels.build()
            for name in _kernels.SOURCES:
                _kernels.load(name)
        _warm_splice(dmap, core_live)
        _warm_fused_step(tracker, dmap, cfg, N, core_live)
        _warm_triangulate(cfg, N, lm.tri_chunk, dev)
        _warm_fuse(cfg, N, core_fuse, dmap)
        _warm_local_ba(cfg, core_ba, dev, segmented=segmented)

    def walk_tail():
        if tail_live:
            # the growth rungs first: map growth reaches them next
            _warm_splice(dmap, tail_live)
            _warm_fused_step(tracker, dmap, cfg, N, tail_live)
        if tail_fuse:
            _warm_fuse(cfg, N, tail_fuse, dmap)
        if tail_ba:
            _warm_local_ba(cfg, tail_ba, dev, segmented=segmented)
        _warm_classic_fallbacks(cfg, N, dev)
        if cfg.system.enable_loop_closing:
            _warm_loop_closing(cfg, N, dmap)

    def run():
        ctx = torch.cuda.stream(stream) if stream is not None else None
        if stream is not None:
            torch.cuda.set_device(dev)
            ctx.__enter__()
        try:
            for part in (walk_core, walk_tail):
                try:
                    part()
                except Exception as e:  # kept; System's join raises it
                    if t.exc is None:
                        t.exc = e
                finally:
                    t.core_ready.set()
        finally:
            if ctx is not None:
                ctx.__exit__(None, None, None)

    t = threading.Thread(target=run, daemon=True, name="iv-prewarm")
    t.exc = None
    t.core_ready = threading.Event()
    t.start()
    return t
