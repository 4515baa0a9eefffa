"""Concurrent introspective stereo sessions on one card, one process each,
as a dataset's sessions are swept: every frame's cost map from the FCN
(``models.inference_cost_map``), then ``System.submit_frontend`` with it,
then ``System.track_stereo``; the next frame is submitted before the
current one is tracked, as the port's run_stereo drives it. Each session
is a closed loop, as fast as it goes, over its own world: one lap of a
closed circuit, rendered in set-up and replayed lap after lap. The worlds
are the same in every run, as a dataset's sequences are (the workload's
world seed); the run's seed deals them to the sessions and draws the FCN's
weights and the frames checked.

The parent builds the CUDA kernels once, then spawns the sessions; each
warms up, and a barrier starts every window at once. A frame counts when
its ``track_stereo`` returns inside the window; a frame tracked into the
LOST state, or left uninitialised, counts as failed.

Checked after the window, in each session: the whole trajectory against
the circuit's exact poses (ATE after a rigid alignment); on frames drawn
from the seed, the cost map against the plain reference's, and the
frontend's keypoints, descriptors and stereo matches against the plain
frontend's (reference/orb) given the same cost map."""

from __future__ import annotations

import os
import sys
import time
from types import SimpleNamespace

import numpy as np

from ..counts import fcn as fcn_counts
from . import common


def _port_config(cfg: dict):
    """The port's Config from the configuration's settings and switches."""
    from iv_slam_tpu_torch import config as pc

    c = pc.Config()
    c.camera = pc.CameraConfig(**cfg["camera"])
    c.orb = pc.ORBConfig(**cfg["orb"])
    c.orb.max_keypoints = max(c.orb.max_keypoints, 1 << (c.orb.n_features - 1).bit_length())
    for k, v in cfg["switches"].items():
        setattr(c.system, k, v)
    c.system.single_threaded = not cfg["switches"]["threaded_local_mapping"]
    return c


def world_of(seed: int, k: int, sessions: int) -> int:
    """The world session k drives: every run drives the same set of worlds
    (a dataset's fixed sequences), the seed deals them to the sessions."""
    from ..traffic import seeds

    return int(seeds.rng(seed, 301).permutation(sessions)[k])


def _session_body(k, seed, cfg, wl, seconds, trace, device, conn) -> dict:
    """One session (its process pinned to a core of its own by
    ``common.run_clients``: sessions that the scheduler moves between cores
    measured 6-8% apart run to run, pinned 2.7%, PERF.md): set up, report
    ready, run the window from the start time the parent sends, check."""
    import cv2
    import torch

    cv2.setNumThreads(1)
    from iv_slam_tpu_torch import models
    from iv_slam_tpu_torch.slam.system import System
    from iv_slam_tpu_torch.slam.tracking import State
    from iv_slam_tpu_torch.utils.profiling import StageTimer

    from ..lib.trace import DeviceTrace, Spans
    from ..traffic import circuit, seeds, world

    dev = torch.device(device)
    cam = cfg["camera"]
    H, W = cam["height"], cam["width"]
    net_hw = tuple(cfg["net_hw"])
    wd = wl["world"]
    scene = world.PlaneWorld(seeds.rng(wd["seed"], 300, world_of(seed, k, wl["sessions"])),
                             tex_size=wd["tex_size"], res=wd["res"],
                             fx=cam["fx"], fy=cam["fy"], cx=cam["cx"], cy=cam["cy"], w=W, h=H,
                             baseline=cam["bf"] / cam["fx"])
    c = wl["circuit"]
    lap = circuit.lap(c["frames"], c["v_min"], c["v_max"], c["aspect"], c["height"],
                      c["yaw_amp"], c["yaw_waves"])
    pairs = [scene.render_stereo(T) for T in lap]
    lefts = torch.from_numpy(np.stack([p[0] for p in pairs]))
    if dev.type == "cuda":
        lefts = lefts.pin_memory()
    calib = lefts[0].to(dev)[None, ..., None].expand(-1, -1, -1, 3)
    net, w = common.seeded_fcn(cfg, seed, dev, calib_rgb=calib)

    system = System(_port_config(cfg), H, W, device=dev)
    tr = system.tracking
    timer = StageTimer()
    tr.stage_timer = tr.local_mapping.stage_timer = timer
    spans = Spans()
    n_lap = len(pairs)
    check_at = set(int(f) for f in wl["check_from"] + common.sample(
        seed, 400 + k, wl["check_span"], wl["check_frames_per_session"]))
    kept = {}

    def submit(f):
        left, right = pairs[f % n_lap]
        t_s = time.time_ns()
        with spans.span("cost_map"):
            img = lefts[f % n_lap].to(dev, non_blocking=True)
            cost = models.inference_cost_map(net, img[..., None].expand(-1, -1, 3), (H, W),
                                             net_hw)
        with spans.span("submit_frontend"):
            handle = system.submit_frontend(left, right, cost_map=cost)
        if f in check_at:
            kept[f] = dict(cost=cost.clone(), kl=tuple(t.clone() for t in handle.kl),
                           kr=tuple(t.clone() for t in handle.kr),
                           u_right=handle.u_right.clone(), depth=handle.depth.clone(),
                           qual=handle.qual.clone())
        return handle, t_s

    frame_ends = []     # (start_ns, end_ns) of each frame, cost map to track return
    lost = 0

    def track(f, handle, t_s):
        nonlocal lost
        left, right = pairs[f % n_lap]
        with spans.span("track_stereo"):
            system.track_stereo(left, right, 0.1 * f, frontend_handle=handle)
        frame_ends.append((t_s, time.time_ns()))
        if system.state != State.OK:   # lost, or never initialised
            lost += 1

    nxt = submit(0)
    f = 0
    for f in range(wl["warmup_frames"]):
        cur, nxt = nxt, submit(f + 1)
        track(f, *cur)
    f += 1
    dt = DeviceTrace(dev) if trace else None
    if dt:
        dt.start()
    common.sync(dev)
    n_kf0 = len(timer.samples.get("keyframe_event", []))
    lost0 = lost
    conn.send(("ready", time.time_ns()))
    t0 = conn.recv()
    t_end = t0 + int(seconds * 1e9)
    common.wait_until(t0)
    frames = 0
    while True:
        cur, nxt = nxt, submit(f + 1)
        track(f, *cur)
        f += 1
        if frame_ends[-1][1] > t_end:
            break
        frames += 1
    common.sync(dev)
    if dt:
        dt.stop()
    peak = int(torch.cuda.max_memory_reserved(dev)) if dev.type == "cuda" else 0
    n_frames = f
    twc = system.trajectory_twc()
    kf_events = timer.samples.get("keyframe_event", [])[n_kf0:]
    failed = lost - lost0
    system.shutdown()
    del system, tr, net, nxt, cur
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    from ..reference import trajectory
    # a trajectory that lost frames has no alignment with the truth
    ate = (trajectory.ate_rmse(np.stack(twc), np.stack([lap[i % n_lap] for i in range(n_frames)]))
           if len(twc) == n_frames else float("inf"))
    if not kept:
        raise RuntimeError(f"session {k}: no frame to check was reached ({n_frames} frames)")
    checks = _check_frames(cfg, w, pairs, kept, dev)
    return dict(
        frames=frames, failed=failed, attempted=frames, ate_m=ate, peak=peak,
        spans=spans.spans, frame_ends=frame_ends, keyframe_event_s=kf_events,
        t_window=(t0, t_end), device=dt.summary(t0, t_end) if dt else None, **checks)


def reference_map(cfg: dict, w: dict, grey, dev, precision: str = "fp32"):
    """The reference's uint8 cost map of a grey frame stacked to RGB."""
    import torch

    from ..reference import fcn as ref

    p, stats = common.split(w)
    cam = cfg["camera"]
    img = torch.from_numpy(grey).to(dev)[None, ..., None].expand(-1, -1, -1, 3)
    return ref.cost_map(cfg["fcn"], p, stats, img, (cam["height"], cam["width"]),
                        tuple(cfg["net_hw"]), precision)[0]


def _check_frames(cfg, w, pairs, kept, dev) -> dict:
    """The kept frames against the plain reference: cost maps, then the
    frontend given the program's cost map; with the K2/K3 byte counts of
    those frames."""
    import torch

    from ..counts import kernels as kc
    from ..reference.orb import brief
    from ..reference.orb.config import ORBConfig
    from ..reference.orb.frontend import StereoFrontend

    cam = cfg["camera"]
    H, W = cam["height"], cam["width"]
    o = cfg["orb"]
    fe = StereoFrontend(ORBConfig(o["n_features"], o["scale_factor"], o["n_levels"],
                                  o["ini_th_fast"], o["min_th_fast"]),
                        SimpleNamespace(bf=cam["bf"], baseline=cam["bf"] / cam["fx"]),
                        H, W, dev)
    n_lap = len(pairs)
    gap = common.MapGap()
    mismatch, slots = 0, 0
    counts = []
    for f, got in sorted(kept.items()):
        left, right = pairs[f % n_lap]
        gap.add(got["cost"], reference_map(cfg, w, left, dev))
        pair = torch.from_numpy(np.stack([left, right])).to(dev)
        r = fe.frame(pair, got["cost"])
        bad = torch.zeros(r.kl.xy.shape[0], dtype=torch.bool, device=dev)
        for side, ref_kp in (("kl", r.kl), ("kr", r.kr)):
            for a, b in zip(got[side], ref_kp):
                ne = a != b
                bad |= ne.reshape(ne.shape[0], -1).any(1)
        for key in ("u_right", "depth", "qual"):
            bad |= got[key] != getattr(r, key)
        mismatch += int(bad.sum())
        slots += bad.numel()
        raw, blur, yx, ang = r.finish
        pat = brief.pattern_indices(*blur.shape, yx.to(torch.int64), ang)
        counts.append(kc.frame_counts(fe.shapes, tuple(raw.shape), yx, pat,
                                      tuple(r.canvas.shape[1:]), *r.sad_centres))
    return dict(cost_max_diff=gap.worst, cost_diff_px=gap.diff_px, cost_px=gap.px,
                frontend_mismatch=mismatch, frontend_slots=slots, kernel_counts=counts)


def run(ctx) -> dict:
    wl, dev = ctx.workload, ctx.device
    print(f"track: {len(os.sched_getaffinity(0))} usable host cores, "
          f"{wl['sessions']} sessions", file=sys.stderr, flush=True)
    if dev.type == "cuda":
        from iv_slam_tpu_torch import _kernels

        _kernels.build(_kernels.SOURCES)
    res = common.run_clients(_session_body, wl["sessions"], (
        ctx.seed, ctx.config, wl, ctx.seconds, ctx.trace, str(dev)), ctx.seconds)
    return aggregate(ctx, res)


def aggregate(ctx, res) -> dict:
    """The run's outcome from the sessions' results."""
    wl = ctx.workload
    t0, t_end = res[0]["t_window"]
    frames = sum(r["frames"] for r in res)
    lim = wl["limits"]
    cost_px = sum(r["cost_px"] for r in res)
    checks = [
        ("ate_max_m", max(r["ate_m"] for r in res), lim["ate_max_m"]),
        ("cost_max_diff", float(max(r["cost_max_diff"] for r in res)), lim["cost_max_diff"]),
        ("cost_diff_share", sum(r["cost_diff_px"] for r in res) / max(cost_px, 1),
         lim["cost_diff_share"]),
        ("frontend_mismatch", float(sum(r["frontend_mismatch"] for r in res)),
         lim["frontend_mismatch"]),
    ]
    spans = [s for r in res for s in r["spans"]]
    # frames cost-mapped and tracked inside the window (the first frame of
    # each session was submitted before the barrier)
    in_win = [(a, b) for r in res for a, b in r["frame_ends"] if t0 <= a and b <= t_end]
    data = dict(
        frame_s=[(b - a) * 1e-9 for a, b in in_win],
        track_s=[(b - a) * 1e-9 for n, a, b in spans if n == "track_stereo" and t0 <= b <= t_end],
        frontend_s=[(b - a) * 1e-9 for n, a, b in spans
                    if n == "submit_frontend" and t0 <= b <= t_end],
        keyframe_event_s=[s for r in res for s in r["keyframe_event_s"]],
        kernel_counts=[c for r in res for c in r["kernel_counts"]],
        frames=frames, forward_flops=fcn_counts.forward_flops(
            ctx.config["fcn"], tuple(ctx.config["net_hw"]), train=False))
    launches = {}
    for r in res:
        if r["device"]:
            for k, v in r["device"]["op_counts"].items():
                launches[k] = launches.get(k, 0) + v
    data["kernel_launches"] = launches
    return dict(
        t0_ns=t0, t1_ns=t_end, attempted=frames + sum(r["failed"] for r in res),
        failed=sum(r["failed"] for r in res),
        e2e=dict(track_fps=frames / ((t_end - t0) * 1e-9)),
        checks=checks, memory_peak_bytes=sum(r["peak"] for r in res), spans=spans,
        device=[r["device"] for r in res if r["device"]], data=data,
        forbidden=common.forbidden(res))
