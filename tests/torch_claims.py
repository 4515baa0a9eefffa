"""The product's claims, run by the PyTorch port (``iv_slam_tpu_torch``).

The JAX package holds itself to four end-to-end checks:
``tests/test_introspection_helps.py`` (IV-SLAM beats ORB-SLAM on a degraded
world), ``tests/test_parity_ate.py`` (the reference C++ system's measured
ATE on seqA, PARITY_ATE.md), ``tests/test_full_cycle.py`` (datagen ->
training -> the trained FCN in the loop) and ``tests/test_kitti_e2e.py``
(everything on at once through the stereo driver at KITTI-00 geometry).
This module runs the same experiments on the port, with the same inputs,
configurations and gates, on the device it is given: ``chip_smoke.py``'s
claims phase and ``claims_smoke.py`` run them on the card,
``tests/test_torch_claims.py`` on the CPU.

It imports torch, numpy and ``synth_world`` (which renders with cv2), and
nothing of JAX or of ``iv_slam_tpu``: images are written with the port's
``io/png.write_png``, the parity vocabulary is trained with the port's
extractor and ``Vocabulary.train``.

Each experiment returns a dict of its numbers, the K1-K3 launches of each
of its runs (the wrappers' counters; on the card each run is gated on one
launch of each a frame, the CPU path launches none), the sha1 of the frames it rendered (cv2 renders one grey level
apart between versions, so ATEs of two machines compare only on equal
digests) and ``gates``: {name: [passed, detail]}, the JAX test's asserts.
``failed(result)`` lists the gates that failed. Every gate is evaluated
(the JAX test stops at its first failing assert; the verdict is the same).
"""

from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np
import torch

import synth_world
from iv_slam_tpu_torch.config import CameraConfig, Config, ORBConfig
from iv_slam_tpu_torch.examples import run_stereo
from iv_slam_tpu_torch.introspection import feature_evaluator
from iv_slam_tpu_torch.io import trajectory
from iv_slam_tpu_torch.io.png import read_png, write_png
from iv_slam_tpu_torch.models.introspection import inference_cost_map
from iv_slam_tpu_torch.ops import fast_cuda, finish_cuda, stereo_cuda
from iv_slam_tpu_torch.ops.extractor import OrbExtractor
from iv_slam_tpu_torch.slam import resolve_device
from iv_slam_tpu_torch.slam.system import System
from iv_slam_tpu_torch.slam.tracking import State
from iv_slam_tpu_torch.slam.vocabulary import Vocabulary
from iv_slam_tpu_torch.train.data import ImageQualityDataset
from iv_slam_tpu_torch.train.trainer import TrainConfig, Trainer

H, W = 240, 320

# ---- the IV cycle (tests/test_introspection_helps.py) ------------------------

# (world, seed, FCN band-response gate /255, ATE margin), as the JAX test's
# CASES: the pinned case, then the three robustness cases
CASES = {
    "reflection-seed5": ("reflection", 5, 50.0, 0.90),
    "reflection-seed11": ("reflection", 11, 20.0, 1.00),
    "reflection-seed23": ("reflection", 23, 20.0, 1.00),
    "shimmer-seed5": ("shimmer", 5, 20.0, 1.00),
}
N_EVAL, N_TRAIN, STEP, TRAIN_PHASE = 40, 60, 0.10, 1.7
ATE_OFF_MIN = 0.15          # the band must hurt vanilla tracking
HEAT_RATIO = 1.5            # heatmap mean inside the band over outside it
MIN_SAMPLES = 4
BAND_X0 = int(0.55 * W)     # the JAX test's split of the heatmaps

# ---- the C++ oracle (tools/parity_reference.py, PARITY_ATE.md) ---------------

SETTINGS_YAML = """%YAML:1.0
Camera.fx: 400.0
Camera.fy: 400.0
Camera.cx: 160.0
Camera.cy: 120.0
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 320
Camera.height: 240
Camera.fps: 10.0
Camera.bf: 200.0
Camera.RGB: 1
ThDepth: 35

ORBextractor.nFeatures: 800
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
ORBextractor.enableIntrospection: 0

ORBMatcher.NNRatioMultiplier: 1.0
ORBMatcher.SearchWindowMultiplier: 1.0

IVSLAM.unsupervisedLearning: 0
Viewer.HeadlessMode: 1
"""
SEQUENCES = {"seqA": (7, 100), "seqB": (23, 100)}
SEQ_STEP = 0.12
# the reference C++ system's ATE RMSE (m) and keyframes on each sequence,
# measured 2026-08-19 (PARITY_ATE.md); the gate is 5% above it
# (BASELINE.md:28-29)
REF_ATE = {"seqA": 0.2485, "seqB": 0.2460}
REF_KEYFRAMES_SEQA = 6
PARITY_MARGIN = 1.05

# ---- the whole cycle (tests/test_full_cycle.py) and KITTI all-on
# (tests/test_kitti_e2e.py) ---------------------------------------------------

CYCLE_SEED, CYCLE_FRAMES, CYCLE_STEP, CYCLE_ON_FRAMES = 42, 12, 0.08, 8
KITTI_FX, KITTI_CX, KITTI_CY = 718.856, 607.19, 185.22
KITTI_W, KITTI_H, KITTI_BASELINE, KITTI_FRAMES = 1241, 376, 0.537, 14
KITTI_SETTINGS = f"""%YAML:1.0
Camera.fx: {KITTI_FX}
Camera.fy: {KITTI_FX}
Camera.cx: {KITTI_CX}
Camera.cy: {KITTI_CY}
Camera.width: {KITTI_W}
Camera.height: {KITTI_H}
Camera.fps: 10.0
Camera.bf: {KITTI_FX * KITTI_BASELINE}
Camera.RGB: 1
ThDepth: 35
ORBextractor.nFeatures: 1200
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


# gates of the JAX tests that the JAX package itself misses on the same
# pixels, on the CPU (ROADMAP section C): the whole cycle's FCN, 2 epochs
# on a clean world's 9 heatmaps, gives a cost map of 0 at every pixel, so
# every keypoint's quality stays 1.0 (600 of 600 in both packages); at
# KITTI geometry no frame qualifies for training (0 scored keypoints in
# both), so no training file is written. chip_smoke.py leaves these gates
# out; claims_smoke.py and the slow CPU tests keep them.
JAX_MISSES = {
    "full_cycle": ("quality from the FCN",),
    "kitti_all_on": ("keypoints > 100", "img_names >= 1", "descriptors.csv",
                     "descriptors_2.csv", "heatmaps written"),
}


def failed(result: dict) -> list:
    """The names of `result`'s gates that failed."""
    return [name for name, (ok, _) in result["gates"].items() if not ok]


def _gate(gates: dict, name: str, ok, detail) -> None:
    gates[name] = [bool(ok), detail]


def _launch_gate(gates: dict, name: str, run: dict, dev) -> None:
    """On the card, K1-K3 launched once a frame in `run` (frames and
    launches); the CPU path launches no kernel."""
    if dev.type == "cuda":
        _gate(gates, f"{name}: K1-K3 once a frame",
              all(n == run["frames"] for n in run["launches"].values()), run["launches"])


def _device(device):
    return resolve_device(device, "torch_claims")


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# each kernel's wrapper module, whose `launches` counts its launches
KERNELS = {"fast_score": fast_cuda, "orient_brief": finish_cuda, "sad_windows": stereo_cuda}


class _Run:
    """Times a run (synced at both ends on the card) and counts the K1-K3
    launches inside it."""

    def __init__(self, dev):
        self.dev = dev

    def __enter__(self):
        for m in KERNELS.values():
            m.launches = 0
        _sync(self.dev)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.dev)
        self.seconds = time.perf_counter() - self.t0
        self.launches = {k: m.launches for k, m in KERNELS.items()}
        return False


def _digest(images) -> str:
    h = hashlib.sha1()
    for img in images:
        h.update(np.ascontiguousarray(img).tobytes())
    return h.hexdigest()


# ---- the IV cycle --------------------------------------------------------------

def iv_config():
    """test_introspection_helps.py's _config."""
    cfg = Config()
    cfg.camera = CameraConfig(fx=400.0, fy=400.0, cx=160.0, cy=120.0, bf=200.0,
                              width=W, height=H, th_depth=35.0, fps=10.0)
    cfg.orb = ORBConfig(n_features=600, n_levels=4)
    cfg.gp.max_train_points = 256
    return cfg


def make_frames(world, n, step, phase=0.0, yaw_amp=0.3):
    """test_introspection_helps.py's _make_frames: a serpentine with real
    rotation (a static image-space band has zero epipolar error under pure
    translation)."""
    gt, frames = [], []
    for i in range(n):
        t = np.array([i * step, 0.03 * np.sin(i * 0.4 + phase), 0.0], np.float32)
        Twc = synth_world.camera_pose(t, height=10.0, yaw=yaw_amp * np.sin(i * 0.3 + phase))
        frames.append(world.render_stereo(Twc))
        gt.append(Twc)
    return frames, gt


def iv_world(case: str):
    """The degraded world of `case` (a key of CASES) at 320x240: a
    ReflectionWorld (band alpha 0.9) or a ShimmerWorld (strength 0.85)."""
    kind, seed, _, _ = CASES[case]
    rng = np.random.default_rng(seed)
    kw = dict(fx=400.0, fy=400.0, cx=160.0, cy=120.0, w=W, h=H, baseline=0.5)
    if kind == "reflection":
        return synth_world.ReflectionWorld(rng, alpha=0.9, **kw)
    return synth_world.ShimmerWorld(rng, strength=0.85, **kw)


def run_system(cfg, frames, gt, dev, net=None, datagen_dir=None, gt_poses=False):
    """test_introspection_helps.py's _run on the port's System: (ATE,
    failures, frames/s, seconds, launches)."""
    s = System(cfg, H, W, device=dev)
    if net is not None:
        # net_hw == the training resolution (the JAX test's comment: through
        # a resize to another grid the small FCN's response vanishes)
        s.tracking.frontend.attach_introspection(net, net_hw=(H, W))
    if datagen_dir is not None:
        s.enable_datagen(datagen_dir)
    with _Run(dev) as run:
        for i, (left, right) in enumerate(frames):
            s.track_stereo(left, right, timestamp=i * 0.1,
                           gt_pose=gt[i] if gt_poses else None, img_name=f"{i:06d}.png")
        if datagen_dir is not None:
            s.tracking.datagen.finalize()
    est = s.trajectory_twc()
    k = len(est)
    ate = trajectory.ate_rmse(est, gt[-k:]) if k >= 2 else float("inf")
    fails = int(s.failure_count)
    s.shutdown()
    return dict(ate_m=float(ate), failures=fails, frames=len(frames),
                frames_per_s=len(frames) / run.seconds, seconds=run.seconds,
                launches=run.launches)


def iv_case(case: str, work: str, device=None, log=print) -> dict:
    """The IV cycle of test_introspection_helps.py on world/seed `case`
    (a key of CASES), its files under `work`: the vanilla run on 40 eval
    frames, datagen on 60 training frames at GT poses (MIN_BAD_PERCENT
    lowered to -1, restored after), the flagship FCN trained 12 epochs at
    (240, 320), the band response of its cost map on every 8th eval frame,
    and the introspective run on the same eval pixels."""


    dev = _device(device)
    kind, seed, band_gate, margin = CASES[case]
    world = iv_world(case)
    eval_frames, eval_gt = make_frames(world, N_EVAL, STEP)
    train_frames, train_gt = make_frames(world, N_TRAIN, STEP, phase=TRAIN_PHASE)
    out = dict(case=case, world=kind, seed=seed, band_gate=band_gate, margin=margin,
               frames_sha1=_digest([im for pair in eval_frames + train_frames for im in pair]))
    gates = out["gates"] = {}

    # vanilla (ORB-SLAM mode): the band hurts
    off = out["off"] = run_system(iv_config(), eval_frames, eval_gt, dev)
    log(f"{case}: OFF ATE {off['ate_m']:.4f} m, {off['failures']} failures")
    _gate(gates, "ate_off > 0.15", off["ate_m"] > ATE_OFF_MIN, off["ate_m"])
    _launch_gate(gates, "off", off, dev)

    # datagen on the training trajectory, dense features
    data_root = os.path.join(work, "data")
    raw_dir = os.path.join(work, "raw", "00000", "image_0")
    ds_dir = os.path.join(data_root, "00000", "generated_training_data")
    os.makedirs(raw_dir)
    for i, (left, _r) in enumerate(train_frames):
        write_png(os.path.join(raw_dir, f"{i:06d}.png"), left)
    cfg = iv_config()
    cfg.iv.enabled = True
    cfg.iv.create_dataset = True
    cfg.orb = ORBConfig(n_features=900, n_levels=4)
    cfg.gp.max_train_points = 512
    old_min = feature_evaluator.MIN_BAD_PERCENT
    feature_evaluator.MIN_BAD_PERCENT = -1.0
    try:
        out["datagen"] = run_system(cfg, train_frames, train_gt, dev, datagen_dir=ds_dir,
                                    gt_poses=True)
    finally:
        feature_evaluator.MIN_BAD_PERCENT = old_min
    _launch_gate(gates, "datagen", out["datagen"], dev)

    # the heatmaps localise the band
    hm_dir = os.path.join(ds_dir, "bad_region_heatmap")
    names = sorted(os.listdir(hm_dir)) if os.path.isdir(hm_dir) else []
    heat_in = heat_out = float("nan")
    if names:
        hms = np.stack([read_png(os.path.join(hm_dir, n)).astype(np.float64) for n in names])
        heat_out, heat_in = float(hms[:, :, :BAND_X0].mean()), float(hms[:, :, BAND_X0:].mean())
    out.update(heatmaps=len(names), heat_in=heat_in, heat_out=heat_out)
    _gate(gates, "heat_in > 1.5 heat_out", heat_in > HEAT_RATIO * heat_out, [heat_in, heat_out])

    # FCN training (the flagship at full width)
    ds = ImageQualityDataset(data_root, os.path.join(work, "raw"), sessions=[0],
                             input_hw=(H, W))
    out["dataset"] = len(ds)
    _gate(gates, "len(ds) >= 4", len(ds) >= MIN_SAMPLES, len(ds))
    if len(ds) == 0:
        return out
    tcfg = TrainConfig(num_epochs=12, batch_size=2, input_hw=(H, W),
                       ckpt_dir=os.path.join(work, "ckpt"), snapshot_interval=100,
                       lr_encoder=0.005, lr_decoder=0.005)
    with _Run(dev) as run:
        trainer = Trainer(tcfg, device=dev)
        hist = trainer.train(ds, val_ds=None, log_fn=lambda *_: None)
    out["train"] = dict(seconds=run.seconds, epochs=tcfg.num_epochs,
                        loss_first=hist.train_loss[0], loss_last=hist.train_loss[-1])
    net = trainer.net.eval()

    # the trained FCN's sharpened cost map flags the band on unseen frames
    band = world.bad_region_mask()
    resp_b, resp_o = [], []
    for left, _r in eval_frames[::8]:
        rgb = torch.from_numpy(np.ascontiguousarray(np.stack([left] * 3, -1))).to(dev)
        cost = inference_cost_map(net, rgb, (H, W), (H, W)).cpu().numpy().astype(np.float32)
        resp_b.append(cost[band].mean())
        resp_o.append(cost[~band].mean())
    fcn_band, fcn_bg = float(np.mean(resp_b)), float(np.mean(resp_o))
    out.update(fcn_band=fcn_band, fcn_bg=fcn_bg, band_response=fcn_band - fcn_bg)
    _gate(gates, f"band response >= {band_gate}", fcn_band - fcn_bg >= band_gate,
          [fcn_band, fcn_bg])

    # introspective run (IV-SLAM mode) on identical eval pixels
    cfg2 = iv_config()
    cfg2.orb.enable_introspection = True
    on = out["on"] = run_system(cfg2, eval_frames, eval_gt, dev, net=net)
    log(f"{case}: ON ATE {on['ate_m']:.4f} m, {on['failures']} failures; band response "
        f"{fcn_band - fcn_bg:.2f}/255, {len(ds)} samples")
    _launch_gate(gates, "on", on, dev)
    _gate(gates, "fails_on <= fails_off", on["failures"] <= off["failures"],
          [on["failures"], off["failures"]])
    _gate(gates, f"ate_on < {margin} ate_off", on["ate_m"] < off["ate_m"] * margin,
          [on["ate_m"], off["ate_m"]])
    return out


# ---- the C++ oracle -------------------------------------------------------------

def write_sequences(work: str, names=("seqA", "seqB"), n_frames=None) -> str:
    """parity_reference.generate: each sequence (PlaneWorld of its seed,
    0.12 m a frame) as a KITTI layout written with the port's PNG writer,
    times.txt and gt_twc.npy, and settings.yaml; `n_frames` cuts each to its
    first frames. Returns the sequences' sha1 digests by name, as JSON."""
    digests = {}
    for name in names:
        seed, n = SEQUENCES[name]
        n = n if n_frames is None else n_frames
        out = os.path.join(work, name)
        for d in ("image_0", "image_1"):
            os.makedirs(os.path.join(out, d), exist_ok=True)
        _, frames, gt = synth_world.make_sequence(np.random.default_rng(seed), n_frames=n,
                                                  step=SEQ_STEP)
        for i, (left, right) in enumerate(frames):
            write_png(os.path.join(out, "image_0", f"{i:06d}.png"), left)
            write_png(os.path.join(out, "image_1", f"{i:06d}.png"), right)
        np.savetxt(os.path.join(out, "times.txt"), [i * 0.1 for i in range(n)], fmt="%.6f")
        np.save(os.path.join(out, "gt_twc.npy"), np.stack(gt))
        digests[name] = _digest([im for pair in frames for im in pair])
    with open(os.path.join(work, "settings.yaml"), "w") as f:
        f.write(SETTINGS_YAML)
    return json.dumps(digests)


def train_vocab(work: str, device=None, every=4) -> dict:
    """parity_reference.train_vocab with the port: the descriptors of every
    `every`-th frame of seqA (800 features, 4 levels), Vocabulary.train(k=9,
    L=4, seed 0), saved as voc.npz. Returns its path, size and launches."""


    dev = _device(device)
    ex = OrbExtractor(ORBConfig(n_features=800, n_levels=4), H, W)
    img_dir = os.path.join(work, "seqA", "image_0")
    n = len(os.listdir(img_dir))
    descs = []
    with _Run(dev) as run:
        for i in range(0, n, every):
            img = read_png(os.path.join(img_dir, f"{i:06d}.png"), "gray")
            kp = ex(torch.from_numpy(img).to(dev))
            descs.append(kp.desc.cpu().numpy()[kp.valid.cpu().numpy()])
        voc = Vocabulary.train(np.concatenate(descs), k=9, L=4, seed=0)
    path = os.path.join(work, "voc.npz")
    voc.save(path)
    return dict(path=path, images=len(descs), descriptors=int(sum(len(d) for d in descs)),
                nodes=len(voc.node_desc), seconds=run.seconds, launches=run.launches)


def oracle(work: str, seq: str = "seqA", device=None, fused=False) -> dict:
    """parity_reference.run_ours on the port: ``python -m
    iv_slam_tpu_torch.examples.run_stereo`` in process with the tool's
    flags (classic tracking, single-threaded, the vocabulary attached;
    `fused` adds --fused_tracking), and the ATE of Trajectory_KITTI_000.txt
    against gt_twc.npy as parity_reference.ate computes it. Gated (classic
    runs only): ATE <= 1.05 x the reference's, no failure."""
    dev = _device(device)
    out = os.path.join(work, f"port_{seq}" + ("_fused" if fused else ""))
    argv = ["--dataset", "kitti", "--data_path", os.path.join(work, seq),
            "--settings_path", os.path.join(work, "settings.yaml"),
            "--out_visualization_path", out, "--vocab_path", os.path.join(work, "voc.npz"),
            "--device", str(dev)] + (["--fused_tracking"] if fused else [])
    with _Run(dev) as run:
        stats = run_stereo.main(argv)
    gt = np.load(os.path.join(work, seq, "gt_twc.npy"))
    est = trajectory.load_kitti(os.path.join(out, "Trajectory_KITTI_000.txt"))
    ate = float(trajectory.ate_rmse(est, list(gt[-len(est):])))
    kfs = np.loadtxt(os.path.join(out, "KeyFrameTrajectory_TUM_000.txt"), ndmin=2)
    res = dict(seq=seq, fused=fused, ate_m=ate, reference_ate_m=REF_ATE[seq],
               gate_m=REF_ATE[seq] * PARITY_MARGIN, frames=int(stats["frames"]),
               failures=int(stats["failures"]), keyframes=int(len(kfs)),
               frames_per_s=stats["frames"] / run.seconds, seconds=run.seconds,
               launches=run.launches, out=out, gates={})
    _launch_gate(res["gates"], "run", res, dev)
    if not fused:
        _gate(res["gates"], f"ATE <= {PARITY_MARGIN} x {REF_ATE[seq]}",
              ate <= REF_ATE[seq] * PARITY_MARGIN, ate)
        _gate(res["gates"], "0 failures", res["failures"] == 0, res["failures"])
    return res


# ---- the whole cycle --------------------------------------------------------------

def full_cycle(work: str, device=None) -> dict:
    """test_full_cycle.py on the port: datagen on 12 frames of
    make_sequence(default_rng(42), step 0.08) at GT poses, 2 epochs of
    training (validated on the same set), then 8 frames with the trained FCN
    attached at net_hw (256, 256)."""
    dev = _device(device)
    _, frames, gt = synth_world.make_sequence(np.random.default_rng(CYCLE_SEED),
                                              n_frames=CYCLE_FRAMES, step=CYCLE_STEP)
    res = dict(frames_sha1=_digest([im for pair in frames for im in pair]), gates={})
    gates = res["gates"]
    data_root, raw_root = os.path.join(work, "data"), os.path.join(work, "raw")
    ds_dir = os.path.join(data_root, "00000", "generated_training_data")
    raw_dir = os.path.join(raw_root, "00000", "image_0")
    os.makedirs(raw_dir)

    cfg = iv_config()
    cfg.iv.enabled = True
    cfg.iv.create_dataset = True
    s = System(cfg, H, W, device=dev)
    s.enable_datagen(ds_dir)
    old_min = feature_evaluator.MIN_BAD_PERCENT
    feature_evaluator.MIN_BAD_PERCENT = -1.0
    try:
        with _Run(dev) as run:
            for i, (left, right) in enumerate(frames):
                name = f"{i:06d}.png"
                write_png(os.path.join(raw_dir, name), left)
                s.track_stereo(left, right, timestamp=i * 0.1, gt_pose=gt[i], img_name=name)
            state_ok = s.state == State.OK
            s.tracking.datagen.finalize()
    finally:
        feature_evaluator.MIN_BAD_PERCENT = old_min
    res["datagen"] = dict(frames=len(frames), frames_per_s=len(frames) / run.seconds,
                          seconds=run.seconds, launches=run.launches)
    _launch_gate(gates, "datagen", res["datagen"], dev)
    hm_dir = os.path.join(ds_dir, "bad_region_heatmap")
    n_hm = len(os.listdir(hm_dir)) if os.path.isdir(hm_dir) else 0
    res["heatmaps"] = n_hm
    _gate(gates, "datagen state OK", state_ok, str(s.state))
    _gate(gates, "heatmaps >= 4", n_hm >= 4, n_hm)

    ds = ImageQualityDataset(data_root, raw_root, sessions=[0], input_hw=(H, W))
    res["dataset"] = len(ds)
    _gate(gates, "len(ds) >= 4", len(ds) >= MIN_SAMPLES, len(ds))
    if len(ds) == 0:
        return res
    tcfg = TrainConfig(num_epochs=2, batch_size=2, input_hw=(H, W),
                       ckpt_dir=os.path.join(work, "ckpt"), snapshot_interval=5,
                       lr_encoder=0.005, lr_decoder=0.005)
    with _Run(dev) as run:
        trainer = Trainer(tcfg, device=dev)
        hist = trainer.train(ds, val_ds=ds, log_fn=lambda *_: None)
    res["train"] = dict(seconds=run.seconds, train_loss=list(hist.train_loss),
                        val_loss=list(hist.val_loss))
    _gate(gates, "train losses finite", np.isfinite(hist.train_loss).all(), hist.train_loss)

    s2 = System(iv_config(), H, W, device=dev)
    s2.tracking.frontend.attach_introspection(trainer.net.eval(), net_hw=(256, 256))
    with _Run(dev) as run:
        for i, (left, right) in enumerate(frames[:CYCLE_ON_FRAMES]):
            s2.track_stereo(left, right, timestamp=i * 0.1)
    res["on"] = dict(frames=CYCLE_ON_FRAMES, frames_per_s=CYCLE_ON_FRAMES / run.seconds,
                     seconds=run.seconds, launches=run.launches, failures=int(s2.failure_count))
    _launch_gate(gates, "on", res["on"], dev)
    _gate(gates, "ON state OK", s2.state == State.OK, str(s2.state))
    _gate(gates, "ON 0 failures", s2.failure_count == 0, int(s2.failure_count))
    cur = s2.tracking.current
    cur.materialize()
    q = np.asarray(cur.qual_score)[np.asarray(cur.valid)]
    res["quality"] = dict(n=int(q.size), min=float(q.min()), max=float(q.max()),
                          not_one=int((q != 1.0).sum()))
    # the FCN's cost map seeds per-keypoint quality (Frame.cc:130-143)
    _gate(gates, "quality from the FCN", (q != 1.0).any(), res["quality"])
    _gate(gates, "quality in (-1, 1]", ((q > -1.0) & (q <= 1.0)).all(), res["quality"])
    s.shutdown()
    s2.shutdown()
    return res


# ---- KITTI geometry, everything on ---------------------------------------------------

def kitti_layout(root: str, device=None) -> dict:
    """test_kitti_e2e.py's fixture on the port: 14 noisy frames of a
    PlaneWorld (seed 5) at KITTI-00 geometry written with the port's PNG
    writer, a KITTI GT file, the settings, and a k=8 L=3 vocabulary from
    frames 0 and 7 (1200 features, 4 levels)."""


    dev = _device(device)
    seq = os.path.join(root, "00")
    for d in ("image_0", "image_1"):
        os.makedirs(os.path.join(seq, d))
    rng = np.random.default_rng(5)
    world = synth_world.PlaneWorld(rng, tex_size=6144, res=40.0, fx=KITTI_FX, fy=KITTI_FX,
                                   cx=KITTI_CX, cy=KITTI_CY, w=KITTI_W, h=KITTI_H,
                                   baseline=KITTI_BASELINE)
    gt, written = [], []
    noise = np.random.default_rng(99)
    for i in range(KITTI_FRAMES):
        t = np.array([i * 0.25, 0.03 * np.sin(i * 0.5), 0.0], np.float32)
        Twc = synth_world.camera_pose(t, height=10.0, yaw=0.03 * np.sin(i * 0.4))
        left, right = world.render_stereo(Twc)
        # per-frame sensor noise, so the supervised datagen gate fires
        for img, name in ((left, "image_0"), (right, "image_1")):
            noisy = np.clip(img.astype(np.int16)
                            + noise.normal(0, 8, img.shape).astype(np.int16),
                            0, 255).astype(np.uint8)
            write_png(os.path.join(seq, name, f"{i:06d}.png"), noisy)
            written.append(noisy)
        gt.append(Twc)
    np.savetxt(os.path.join(seq, "times.txt"), np.arange(KITTI_FRAMES) * 0.1)
    gt_file = os.path.join(root, "00_gt.txt")
    np.savetxt(gt_file, np.stack([T[:3, :4].reshape(-1) for T in gt]))
    settings = os.path.join(root, "kitti.yaml")
    with open(settings, "w") as f:
        f.write(KITTI_SETTINGS)
    ex = OrbExtractor(ORBConfig(n_features=1200, n_levels=4), KITTI_H, KITTI_W)
    descs = []
    for i in (0, KITTI_FRAMES // 2):
        img = read_png(os.path.join(seq, "image_0", f"{i:06d}.png"))
        kp = ex(torch.from_numpy(img).to(dev))
        descs.append(kp.desc.cpu().numpy()[kp.valid.cpu().numpy()])
    voc = Vocabulary.train(np.concatenate(descs), k=8, L=3, seed=0)
    vocab = os.path.join(root, "voc.npz")
    voc.save(vocab)
    return dict(seq=seq, gt_file=gt_file, settings=settings, vocab=vocab,
                frames_sha1=_digest(written))


def kitti_all_on(root: str, device=None) -> dict:
    """test_kitti_e2e.py on the port: run_stereo in process over
    kitti_layout's files with --fused_tracking --ivslam_enabled
    --create_ivslam_dataset --run_single_threaded and the vocabulary, and
    the JAX test's asserts on its outputs."""
    dev = _device(device)
    lay = kitti_layout(root, dev)
    out, dataset = os.path.join(root, "out"), os.path.join(root, "generated_training_data")
    argv = ["--dataset", "kitti", "--data_path", lay["seq"], "--settings_path",
            lay["settings"], "--ground_truth_path", lay["gt_file"], "--vocab_path",
            lay["vocab"], "--out_visualization_path", out, "--out_dataset_path", dataset,
            "--fused_tracking", "--ivslam_enabled", "--create_ivslam_dataset",
            "--run_single_threaded", "--device", str(dev)]
    with _Run(dev) as run:
        run_stereo.main(argv)
    res = dict(frames_sha1=lay["frames_sha1"], seconds=run.seconds, launches=run.launches,
               gates={})
    gates = res["gates"]
    stats = json.loads(open(os.path.join(out, "stats.json")).read())
    res.update(frames=stats["frames"], failures=stats["failures"], ate_m=stats["ate_rmse"],
               frames_per_s=stats["frames"] / run.seconds)
    _launch_gate(gates, "run", res, dev)
    _gate(gates, f"frames == {KITTI_FRAMES}", stats["frames"] == KITTI_FRAMES, stats["frames"])
    _gate(gates, "0 failures", stats["failures"] == 0, stats["failures"])
    _gate(gates, "ATE < 0.5", stats["ate_rmse"] < 0.5, stats["ate_rmse"])
    traj = np.loadtxt(os.path.join(out, "Trajectory_KITTI_000.txt"))
    _gate(gates, "trajectory rows", traj.shape == (KITTI_FRAMES, 12), list(traj.shape))
    for f in ("KeyFrameTrajectory_TUM_000.txt", "failure_log.txt"):
        _gate(gates, f, os.path.exists(os.path.join(out, f)), f)
    kps = json.loads(open(os.path.join(dataset, "keypoints.json")).read())
    _gate(gates, "keypoints.json keys", set(kps) == {"x_coord", "y_coord", "response", "size",
                                                    "epipolar_err"}, sorted(kps))
    res["keypoints"] = len(kps.get("x_coord", []))
    _gate(gates, "keypoints > 100", res["keypoints"] > 100, res["keypoints"])
    names = json.loads(open(os.path.join(dataset, "img_names.json")).read())
    res["training_images"] = len(names["img_name"])
    _gate(gates, "img_names >= 1", res["training_images"] >= 1, res["training_images"])
    for f in ("descriptors.csv", "descriptors_2.csv"):
        _gate(gates, f, os.path.exists(os.path.join(dataset, f)), f)
    hm_dir = os.path.join(dataset, "bad_region_heatmap")
    heatmaps = sorted(n for n in os.listdir(hm_dir) if n.endswith(".png")) \
        if os.path.isdir(hm_dir) else []
    res["heatmaps"] = len(heatmaps)
    _gate(gates, "heatmaps written", heatmaps, len(heatmaps))
    if heatmaps:
        hm = read_png(os.path.join(hm_dir, heatmaps[0]))
        _gate(gates, "heatmap shape", hm.shape[0] == KITTI_H // 8 or hm.shape[0] > 100,
              list(hm.shape))
    return res
