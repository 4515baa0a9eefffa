"""Port parity: the monocular and RGB-D sensors against the JAX package,
on tests/test_mono_rgbd.py's world (a TwoPlaneWorld seen from 10 m, 320x240,
0.25 m a frame) at a short horizon.

* MonoFrontend (without and with a cost map) and RGBDFrontend (a float
  depth map, depth_scale 1, and a uint16 map at 1/5000 as TUM stores it):
  every Frame field exact against the JAX frontends (no-FMA subprocess,
  tests/torch_parity.py);
* sample_gt_depth: exact (host numpy in both packages);
* a mono System and an RGB-D System, fused tracking, over 8 frames against
  the JAX package's (the mono initializer on JAX's own 8-point draws; the
  RGB-D System with a keyframe forced every third frame, so that its
  keyframe events run within the horizon): the
  same state every frame (the same initialisation frame), the same
  keyframes and map size, the last frame's associations and chi2 degrees
  of freedom exact; poses within 2e-3 (the System tolerance of
  tests/test_torch_system.py: the pose LM's weakly constrained direction),
  the last frame's pose-LM chi2 within 0.05 + 5% (it carries that pose
  difference);
* the mono System's own draws (``initializer.sample_init``): it
  initialises, stays OK and moves along the ground truth's direction
  (tests/test_mono_rgbd.py's gate: cosine > 0.95).
"""

import numpy as np
import pytest
import torch

from iv_slam_tpu.slam import frame as jframe
from iv_slam_tpu_torch.io import trajectory
from iv_slam_tpu_torch.slam.frame import MonoFrontend, RGBDFrontend, sample_gt_depth
from iv_slam_tpu_torch.slam.system import System
from iv_slam_tpu_torch.slam.tracking import State
from test_torch_fused_track import port_config
from torch_parity import (force_keyframe, jax_pnp_indices, mono_rgbd_world,  # noqa: F401
                          one_thread, run_reference)

pytestmark = pytest.mark.usefixtures("one_thread")

CAM = (400.0, 400.0, 160.0, 120.0, 200.0, 320, 240)
N_FRAMES = 8
KF_EVERY = {"mono": 0, "rgbd": 3}


def jax_init_indices(key_id, valid, device=None):
    return jax_pnp_indices(key_id, valid, device, n_hyp=200, sample_size=8)


@pytest.fixture(scope="module")
def world():
    return mono_rgbd_world(N_FRAMES)


def _cost_map(h, w, seed=4):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    c = 127.5 + 127.5 * np.sin(xx / (7 + 5 * r.uniform())) * np.cos(yy / (9 + 5 * r.uniform()))
    return np.clip(c, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def reference(world, tmp_path_factory):
    """The JAX frontends on frame 3 and the JAX Systems over the frames,
    in one no-FMA subprocess."""
    imgs, depths, _ = world
    return run_reference("mono_rgbd", tmp_path_factory.mktemp("mono_rgbd"), timeout=600.0,
                         img=imgs[3], cost_map=_cost_map(240, 320), depth_f=depths[3],
                         depth_u16=np.round(depths[3] * 5000.0).astype(np.uint16),
                         imgs=imgs, depths=depths, cam=np.array(CAM), n_features=800,
                         n_levels=4, fused=True, kf_every_rgbd=KF_EVERY["rgbd"])


def check_frame(fr, ref, name):
    for f in ("xy", "response", "octave", "angle", "desc", "valid", "yx_level"):
        np.testing.assert_array_equal(getattr(fr.kp, f).numpy(), ref[f"{name}_{f}"],
                                      err_msg=f"{name} {f}")
    for f in ("u_right", "depth", "qual_score", "xy", "octave", "valid", "frame_id"):
        np.testing.assert_array_equal(np.asarray(getattr(fr, f)), ref[f"{name}_{f}"],
                                      err_msg=f"{name} {f}")
    # the device copies the fused step reads hold the host values
    for f, dev in (("u_right", fr.ur_dev), ("depth", fr.depth_dev), ("qual_score", fr.qual_dev)):
        np.testing.assert_array_equal(dev.numpy(), getattr(fr, f))


def test_mono_frontend_matches_jax(world, reference):
    imgs = world[0]
    mono = MonoFrontend(port_config(CAM, 800, 4), 240, 320, device="cpu")
    check_frame(mono.process(imgs[3], 0.0), reference, "mono")
    fq = mono.process(imgs[3], 0.1, _cost_map(240, 320))
    check_frame(fq, reference, "monoq")
    assert len(np.unique(fq.qual_score)) > 20


@pytest.mark.parametrize("depth_kind", ["float", "uint16"])
def test_rgbd_frontend_matches_jax(world, reference, depth_kind):
    imgs, depths, _ = world
    rgbd = RGBDFrontend(port_config(CAM, 800, 4), 240, 320, device="cpu")
    if depth_kind == "uint16":
        rgbd._frame_count = 1
        fr = rgbd.process(imgs[3], np.round(depths[3] * 5000.0).astype(np.uint16), 0.1,
                          1.0 / 5000.0)
    else:
        fr = rgbd.process(imgs[3], depths[3], 0.0, 1.0)
    check_frame(fr, reference, "rgbdf" if depth_kind == "float" else "rgbdu")
    assert (fr.depth > 0).sum() > 300


def test_sample_gt_depth_matches_jax(rng):
    depth = rng.uniform(1, 700, (60, 80)).astype(np.float32)
    xy = np.concatenate([rng.uniform(-2, 82, (300, 2)), [[0.5, 0.5], [79.5, 59.5]]])
    xy = xy.astype(np.float32)
    valid = rng.uniform(size=len(xy)) < 0.9
    got = sample_gt_depth(depth, xy, valid)
    np.testing.assert_array_equal(got, jframe.sample_gt_depth(depth, xy, valid))
    assert (got < 0).sum() > 30 and (got > 0).sum() > 200


@pytest.mark.parametrize("sensor", ["mono", "rgbd"])
def test_system_matches_jax(world, reference, sensor):
    imgs, depths, gt = world
    ref = {k[len(sensor) + 1:]: v for k, v in reference.items() if k.startswith(sensor + "_")}
    cfg = port_config(CAM, 800, 4)
    cfg.system.sensor = sensor
    cfg.system.fused_tracking = True
    s = System(cfg, 240, 320, device="cpu")
    s.tracking.init_sampler = jax_init_indices
    states = []
    for i, img in enumerate(imgs):
        if sensor == "mono":
            s.track_mono(img, i * 0.1)
        else:
            s.track_rgbd(img, depths[i], i * 0.1)
            force_keyframe(s.tracking, i, KF_EVERY[sensor])
        states.append(s.state.value)
    tr, m = s.tracking, s.tracking.map
    np.testing.assert_array_equal(states, ref["states"])
    assert states[-1] == State.OK.value and states[1 if sensor == "mono" else 0] == State.OK.value
    assert m.n_keyframes == int(ref["n_keyframes"]) >= 3
    assert m.n_points == int(ref["n_points"])
    assert int(m.pt_alive[:m.n_points].sum()) == int(ref["n_alive"])
    np.testing.assert_array_equal(m.kf_frame_id[:m.n_keyframes], ref["kf_frame_id"])
    np.testing.assert_array_equal(tr.current.map_pt, ref["map_pt"])
    np.testing.assert_array_equal(tr.current.chi2_dof, ref["chi2_dof"])
    np.testing.assert_allclose(tr.current.chi2, ref["chi2"], rtol=0.05, atol=0.05)
    est = np.stack(s.trajectory_twc())
    np.testing.assert_allclose(est[:, :3, 3], ref["twc"][:, :3, 3], rtol=0, atol=2e-3)
    np.testing.assert_allclose(est[:, :3, :3], ref["twc"][:, :3, :3], rtol=0, atol=2e-3)
    if sensor == "rgbd":
        assert trajectory.ate_rmse(list(est), list(gt)) < 0.05


def test_mono_system_own_draws_tracks(world):
    imgs, _, gt = world
    cfg = port_config(CAM, 800, 4)
    cfg.system.sensor = "mono"
    s = System(cfg, 240, 320, device="cpu")
    states = []
    for i, img in enumerate(imgs):
        s.track_mono(img, i * 0.1)
        states.append(s.state)
    assert State.OK in states, states
    first_ok = states.index(State.OK)
    assert all(st == State.OK for st in states[first_ok:]), states
    est = s.trajectory_twc()[first_ok - 1:]
    d_est = est[-1][:3, 3] - est[0][:3, 3]
    d_gt = gt[-1][:3, 3] - gt[first_ok - 1][:3, 3]
    cos = float(d_est @ d_gt / max(np.linalg.norm(d_est) * np.linalg.norm(d_gt), 1e-9))
    assert cos > 0.95, cos
