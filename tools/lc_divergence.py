#!/usr/bin/env python3
"""Where the card's loop leaves the CPU path's on bench.py's LC world.

Drives chip_smoke.py phase 7's control run (bench.py's LC world, 320x240,
800 features, 8 levels, fused tracking, unchained, single-threaded,
synchronous local BA, no vocabulary) through two ``System``s in lockstep,
one on the card and one on the port's CPU path. A stage timer on each
records the System's state at the end of every timed stage (frontend,
dmap_sync, fused_dispatch, fused_readback, track, keyframe_event and its
lm_* stages) and the two are compared stage by stage:

* discrete state: tracking state, reference keyframe, keyframe and point
  counts, live flags, observation counts, the current frame's point ids;
* floats: the current pose, the velocity, every keyframe pose and point.

It reports the first stage whose floats differ (with the number of entries,
the largest difference and the largest distance in float32 ulps), the first
stage whose discrete state differs and what differs there, every frame's
largest pose difference, and both runs' ATE (bench.py's definition).

Two machines (another torch, cv2 or numpy, another CPU) are compared
through traces: ``--trace OUT.npz`` runs one System alone (on ``--card``)
and writes a digest of every field at the end of every stage, with the pose
floats at every stage and the points, live flags and observation counts at
the end of each keyframe-event stage, and the digest of the world's images;
``--compare A.npz B.npz`` names the first stage where two traces differ and
what differs there. ``--save-pairs F.npz`` writes the rendered world, and
``--pairs F.npz`` runs on a world another machine rendered.

Run from the root of a checkout:
    python3 tools/lc_divergence.py [--frames 240]                   (a GPU)
    python3 tools/lc_divergence.py --trace OUT.npz [--card cpu] [--pairs F.npz]
    python3 tools/lc_divergence.py --compare A.npz B.npz
    python3 tools/lc_divergence.py --save-pairs F.npz
The lockstep run prints one JSON line last, and writes it, with every
frame's differences, to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import hashlib
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LC_H, LC_W = 240, 320


def lc_world(n):
    """bench.py's _lc_world(n) (bench.py:378-413), as chip_smoke.py phase 7
    builds it: (stereo pairs, ground-truth Twc)."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import synth_world

    world = synth_world.DistinctTerrainWorld(
        np.random.default_rng(3), tex_size=8192, res=60.0, fx=400.0, fy=400.0,
        cx=160.0, cy=120.0, w=LC_W, h=LC_H, baseline=0.5)
    pairs, gt = [], []
    for i in range(n):
        ang = 2.9 * np.pi * i / n
        Twc = synth_world.camera_pose(
            np.array([6.0 * np.sin(ang), 6.0 * (1 - np.cos(ang)), 0.0], np.float32),
            height=10.0, yaw=ang)
        pairs.append(world.render_stereo(Twc))
        gt.append(Twc)
    return pairs, gt


def world_digest(pairs):
    """sha1 of every image of the world, in order (16 hex digits)."""
    h = hashlib.sha1()
    for left, right in pairs:
        h.update(np.ascontiguousarray(left).tobytes())
        h.update(np.ascontiguousarray(right).tobytes())
    return h.hexdigest()[:16]


def world(n, pairs_path=None):
    """The LC world's pairs and ground truth: rendered, or loaded from a
    file that --save-pairs wrote (another machine's render)."""
    if pairs_path:
        z = np.load(pairs_path)
        return list(zip(z["left"], z["right"])), list(z["gt"])
    return lc_world(n)


def lc_config():
    """bench.py:463-471's configuration (chip_smoke.py phase 7)."""
    from iv_slam_tpu_torch import config as C

    cfg = C.Config()
    cfg.camera = C.CameraConfig(fx=400.0, fy=400.0, cx=160.0, cy=120.0, bf=200.0,
                                width=LC_W, height=LC_H, th_depth=35.0, fps=4.0)
    cfg.orb = C.ORBConfig(n_features=800, n_levels=8)
    cfg.system.fused_tracking = True
    return cfg


def state(s):
    """The System's state: (discrete fields, float fields), host copies."""
    tr = s.tracking
    m = tr.map
    nk, npt = m.n_keyframes, m.n_points
    cur = tr.current
    disc = dict(state=np.array(int(tr.state.value)), ref_kf=np.array(int(tr.ref_kf)),
                n_kf=np.array(nk), n_pt=np.array(npt), kf_alive=m.kf_alive[:nk].copy(),
                pt_alive=m.pt_alive[:npt].copy(), pt_n_obs=m.pt_n_obs[:npt].copy(),
                cur_map_pt=None if cur is None or cur.map_pt is None else cur.map_pt.copy())
    flt = dict(cur_pose=None if cur is None or cur.pose is None else cur.pose.copy(),
               velocity=None if tr.velocity is None else np.asarray(tr.velocity).copy(),
               kf_pose=m.kf_pose[:nk].copy(), pt_pos=m.pt_pos[:npt].copy())
    return disc, flt


class Probe:
    """A stage timer whose time(name) records the state at the stage's end."""

    def __init__(self, system):
        self.s, self.frame, self.log = system, -1, []

    @contextlib.contextmanager
    def time(self, name):
        yield
        self.log.append((name, state(self.s)))


def ulps(a, b):
    """Largest distance in float32 ulps between same-signed entries."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    same = np.sign(a) == np.sign(b)
    return int(np.abs(ia - ib)[same].max()) if same.any() else None


def compare(a, b):
    """Discrete fields that differ (entries differing, or the shapes) and
    float fields that differ (entries, largest |diff|, largest ulps)."""
    disc, flt = {}, {}
    for k, x in a[0].items():
        y = b[0][k]
        if (x is None) != (y is None):
            disc[k] = "one side None"
        elif x is not None and np.shape(x) != np.shape(y):
            disc[k] = f"shapes {np.shape(x)} / {np.shape(y)}"
        elif x is not None and not np.array_equal(x, y):
            disc[k] = int(np.sum(x != y))
    for k, x in a[1].items():
        y = b[1][k]
        if x is None or y is None or np.shape(x) != np.shape(y):
            if (x is None) != (y is None) or (x is not None and np.shape(x) != np.shape(y)):
                disc[k] = "float field shape differs"
            continue
        x, y = np.asarray(x, np.float32), np.asarray(y, np.float32)
        if not np.array_equal(x, y):
            d = np.abs(x.astype(np.float64) - y)
            flt[k] = dict(entries=int(np.sum(x != y)), of=int(x.size),
                          max_abs=float(d.max()), max_ulps=ulps(x, y))
    return disc, flt


EVENT_STAGES = ("lm_cull_points", "lm_triangulate", "lm_fuse", "lm_local_ba",
                "lm_cull_keyframes", "keyframe_event")


class Tracer:
    """A stage timer that keeps a trace: per stage end, (frame, stage, the
    digest of every field); the pose floats at every stage end; the points,
    live flags and observation counts at keyframe-event stage ends."""

    def __init__(self, system):
        self.s, self.frame = system, -1
        self.rows, self.arrays = [], {}

    @contextlib.contextmanager
    def time(self, name):
        yield
        disc, flt = state(self.s)
        fields = {**disc, **flt}
        j = len(self.rows)
        self.rows.append(dict(frame=self.frame, stage=name, digest={
            k: None if v is None else hashlib.sha1(
                np.ascontiguousarray(v).tobytes()).hexdigest()[:16]
            for k, v in fields.items()}))
        keep = ("cur_pose", "velocity", "kf_pose", "cur_map_pt")
        if name in EVENT_STAGES:
            keep += ("pt_pos", "pt_alive", "pt_n_obs")
        for k in keep:
            if fields[k] is not None:
                self.arrays[f"{j}/{k}"] = fields[k]

    def save(self, path, **meta):
        np.savez_compressed(path, rows=json.dumps(self.rows), meta=json.dumps(meta),
                            **self.arrays)


def compare_traces(a_path, b_path):
    """The first stage end where two traces' digests differ: its frame,
    stage and fields, with each kept field's entries that differ, largest
    difference and ulps; and the first discrete difference."""
    A, B = np.load(a_path), np.load(b_path)
    ra, rb = json.loads(str(A["rows"])), json.loads(str(B["rows"]))
    first = first_disc = None
    discrete = ("state", "ref_kf", "n_kf", "n_pt", "kf_alive", "pt_alive", "pt_n_obs",
                "cur_map_pt")
    for j, (x, y) in enumerate(zip(ra, rb)):
        if (x["frame"], x["stage"]) != (y["frame"], y["stage"]):
            first_disc = first_disc or dict(frame=x["frame"], stage=x["stage"],
                                            differs="stage sequence",
                                            other=(y["frame"], y["stage"]))
            break
        bad = [k for k in x["digest"] if x["digest"][k] != y["digest"][k]]
        if not bad:
            continue
        detail = {}
        for k in bad:
            key = f"{j}/{k}"
            if key in A.files and key in B.files and A[key].shape == B[key].shape:
                u, v = A[key], B[key]
                if k in discrete:
                    detail[k] = dict(entries=int(np.sum(u != v)), of=int(u.size))
                else:
                    d = np.abs(u.astype(np.float64) - v)
                    detail[k] = dict(entries=int(np.sum(u != v)), of=int(u.size),
                                     max_abs=float(d.max()), max_ulps=ulps(u, v))
            else:
                detail[k] = "digest differs"
        row = dict(frame=x["frame"], stage=x["stage"], index=j, fields=detail)
        first = first or row
        if any(k in discrete for k in bad):
            first_disc = row
            break
    return dict(a=a_path, b=b_path, a_meta=json.loads(str(A["meta"])),
                b_meta=json.loads(str(B["meta"])), stage_ends=[len(ra), len(rb)],
                first_difference=first, first_discrete_difference=first_disc)


def trace_run(n, device, out, pairs_path=None):
    """One System on `device` over the LC world with a Tracer; saved to out."""
    import cv2
    import torch

    from iv_slam_tpu_torch.io import trajectory
    from iv_slam_tpu_torch.slam import system

    pairs, gt = world(n, pairs_path)
    n = len(pairs)
    s = system.System(lc_config(), LC_H, LC_W, device=device)
    tracer = Tracer(s)
    s.tracking.stage_timer = s.tracking.local_mapping.stage_timer = tracer
    for i in range(n):
        tracer.frame = i
        s.track_stereo(*pairs[i], timestamp=i * 0.1)
    est = s.trajectory_twc()
    ate = trajectory.ate_rmse(est, gt[-len(est):])
    meta = dict(device=device, frames=n, ate_m=ate, world=pairs_path or "rendered",
                world_sha1=world_digest(pairs), numpy=np.__version__, cv2=cv2.__version__,
                torch=torch.__version__,
                cuda=torch.version.cuda, card=card_line() if device == "cuda" else None,
                keyframes=int(s.tracking.map.n_keyframes), points=int(s.tracking.map.n_points))
    tracer.save(out, **meta)
    return meta


def position(T):
    return None if T is None else (-T[:3, :3].T @ T[:3, 3]).astype(np.float64)


def card_line():
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--card", default="cuda", help="the first System's device (cpu: a dry run)")
    ap.add_argument("--trace", default=None, help="write one System's trace here")
    ap.add_argument("--compare", nargs=2, default=None, help="two traces to compare")
    ap.add_argument("--pairs", default=None, help="run on the world saved in this file")
    ap.add_argument("--save-pairs", default=None, help="save the rendered world here")
    ap.add_argument("--out", default=None, help="write the lockstep result here (JSON)")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    if args.save_pairs:
        pairs, gt = lc_world(args.frames)
        np.savez_compressed(args.save_pairs, left=np.stack([p[0] for p in pairs]),
                            right=np.stack([p[1] for p in pairs]), gt=np.stack(gt))
        print(json.dumps(dict(saved=args.save_pairs, world_sha1=world_digest(pairs))))
        return 0
    if args.compare:
        print(json.dumps(compare_traces(*args.compare), default=float))
        return 0
    if args.trace:
        print(json.dumps(trace_run(args.frames, args.card, args.trace, args.pairs),
                         default=float))
        return 0
    import torch

    if args.card == "cuda" and not torch.cuda.is_available():
        print("lc_divergence: no CUDA device", file=sys.stderr)
        return 2
    from iv_slam_tpu_torch.io import trajectory
    from iv_slam_tpu_torch.slam import system

    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    pairs, gt = world(args.frames, args.pairs)
    cfg = lc_config()
    sys_ = {"cuda": system.System(copy.deepcopy(cfg), LC_H, LC_W, device=args.card),
            "cpu": system.System(copy.deepcopy(cfg), LC_H, LC_W, device="cpu")}
    probes = {}
    for dev, s in sys_.items():
        probes[dev] = Probe(s)
        s.tracking.stage_timer = s.tracking.local_mapping.stage_timer = probes[dev]

    first_float = first_disc = None
    frames = []
    for i in range(len(pairs)):
        for dev, s in sys_.items():
            probes[dev].frame, probes[dev].log = i, []
            s.track_stereo(*pairs[i], timestamp=i * 0.1)
        lg, lc = probes["cuda"].log, probes["cpu"].log
        names_g, names_c = [n for n, _ in lg], [n for n, _ in lc]
        if first_disc is None and names_g != names_c:
            first_disc = dict(frame=i, stage="stage sequence", differs=dict(
                card=names_g, cpu=names_c))
        if first_disc is None:
            for (name, a), (_, b) in zip(lg, lc):
                disc, flt = compare(a, b)
                if flt and first_float is None:
                    first_float = dict(frame=i, stage=name, floats=flt,
                                       discrete_equal=not disc)
                if disc:
                    first_disc = dict(frame=i, stage=name, differs=disc, floats=flt)
                    break
        trk = {dev: s.tracking for dev, s in sys_.items()}
        pg, pc = (position(trk[d].current.pose) for d in ("cuda", "cpu"))
        frames.append(dict(
            frame=i, keyframe_event="keyframe_event" in names_g,
            d_position_m=None if pg is None or pc is None else float(np.abs(pg - pc).max()),
            keyframes=[int(trk[d].map.n_keyframes) for d in ("cuda", "cpu")],
            points=[int(trk[d].map.n_points) for d in ("cuda", "cpu")]))
    lockstep_s = time.perf_counter() - t0
    runs = {}
    for dev, s in sys_.items():
        est = s.trajectory_twc()
        runs[dev] = dict(ate_m=trajectory.ate_rmse(est, gt[-len(est):]),
                         lost=int(sum(s.tracking.lost_flags)),
                         keyframes=int(s.tracking.map.n_keyframes),
                         points=int(s.tracking.map.n_points))
    print(f"lockstep card and CPU path, {len(pairs)} frames in {lockstep_s:.1f} s: {runs}")
    print(f"first float difference: {json.dumps(first_float)}")
    print(f"first discrete difference: {json.dumps(first_disc)}")
    for f in frames:
        if f["keyframe_event"] or f["frame"] % 20 == 0:
            print(f"  frame {f['frame']}: |d position| {f['d_position_m']}, keyframes "
                  f"{f['keyframes']}, points {f['points']}"
                  f"{', keyframe event' if f['keyframe_event'] else ''}")

    out = dict(card=card, frames=len(pairs), world_sha1=world_digest(pairs), runs=runs,
               first_float_difference=first_float,
               first_discrete_difference=first_disc,
               per_frame=frames, configuration="chip_smoke.py phase 7 (a): no vocabulary")
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps({"lc_divergence": out}, default=float) + "\n")
    print(json.dumps({k: v for k, v in out.items() if k != "per_frame"}, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
