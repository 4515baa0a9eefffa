"""Port parity: the whole frontend slice, StereoFrontend (image pair ->
Frame) on CPU tensors, vs the JAX package's StereoFrontend.

The frame is a tests/synth_world.py PlaneWorld view at the configuration of
tests/test_stereo_pallas.py. Every Frame field and the (N, 7) host pack
must equal the JAX frontend's, compiled without FMA contraction
(tests/torch_parity.py). Also: the ported config round-trips with the JAX
package's, the BRIEF pattern file is a byte-for-byte copy, and the
frontend refuses to pick the CPU on its own.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from iv_slam_tpu import config as jconfig
from iv_slam_tpu_torch import config as tconfig
from iv_slam_tpu_torch.slam.frame import StereoFrontend
from synth_world import PlaneWorld, camera_pose
from torch_parity import KP_FIELDS, run_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def world_frame():
    rng = np.random.default_rng(3)
    world = PlaneWorld(rng)
    left, right = world.render_stereo(camera_pose((0, 0), height=10.0))
    cfg = tconfig.Config()
    cfg.camera = tconfig.CameraConfig(fx=400.0, fy=400.0, cx=160.0, cy=120.0,
                                      bf=world.bf, width=world.w, height=world.h)
    cfg.orb = tconfig.ORBConfig(n_features=400, n_levels=4, max_keypoints=1024)
    cam = np.array([400.0, 400.0, 160.0, 120.0, world.bf, world.w, world.h])
    return cfg, cam, left, right


def test_stereo_frontend_matches_jax(world_frame, tmp_path):
    cfg, cam, left, right = world_frame
    ref = run_reference("frontend", tmp_path, left=left, right=right, cam=cam,
                        n_features=400, n_levels=4, max_keypoints=1024)
    fe = StereoFrontend(cfg, left.shape[0], left.shape[1], device="cpu")
    fr = fe.process(left, right, 0.0)
    for f in KP_FIELDS:
        np.testing.assert_array_equal(getattr(fr.kp, f).numpy(), ref[f], err_msg=f)
    for f in ("u_right", "depth", "qual_score"):
        np.testing.assert_array_equal(getattr(fr, f), ref[f], err_msg=f)
    for f in ("xy", "octave", "valid"):
        np.testing.assert_array_equal(getattr(fr, f), ref["fr_" + f], err_msg=f)
    np.testing.assert_array_equal(fr.desc, ref["desc"])
    np.testing.assert_array_equal(fr.angle, ref["angle"])
    assert (fr.depth > 0).sum() > 50

    # submit/collect, with and without the host prefetch, and deferred
    h = fe.submit(left, right)
    np.testing.assert_array_equal(h.host_pack.numpy(), ref["host_pack"])
    fe.prefetch_host(h)
    fr2 = fe.collect(h, 1.0)
    np.testing.assert_array_equal(fr2.u_right, ref["u_right"])
    fr3 = fe.process(left, right, 2.0, defer=True)
    assert fr3.xy is None
    fr3.materialize()
    np.testing.assert_array_equal(fr3.depth, ref["depth"])
    np.testing.assert_array_equal(fr3.xy, ref["fr_xy"])
    assert [fr.frame_id, fr2.frame_id, fr3.frame_id] == [0, 1, 2]


def _cost_map(h, w, seed=9):
    """A uint8 cost map: smooth waves with noise over the whole range."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    m = 128 + 127 * np.sin(xx / 29.0 + 1.0) * np.cos(yy / 19.0) + rng.normal(0, 15, (h, w))
    return np.clip(m, 0, 255).astype(np.uint8)


def test_stereo_frontend_with_cost_map_matches_jax(world_frame, tmp_path):
    """The cost map weights the left image's extraction (the right image
    gets a zero map) and seeds each keypoint's quality at rint(xy): every
    Frame field and the host pack exact."""
    cfg, cam, left, right = world_frame
    cost = _cost_map(*left.shape)
    ref = run_reference("frontend", tmp_path, left=left, right=right, cam=cam,
                        n_features=400, n_levels=4, max_keypoints=1024, cost_map=cost)
    fe = StereoFrontend(cfg, left.shape[0], left.shape[1], device="cpu")
    fr = fe.process(left, right, 0.0, cost_map=cost)
    for f in KP_FIELDS:
        np.testing.assert_array_equal(getattr(fr.kp, f).numpy(), ref[f], err_msg=f)
    for f in ("u_right", "depth", "qual_score"):
        np.testing.assert_array_equal(getattr(fr, f), ref[f], err_msg=f)
    for f in ("xy", "octave", "valid"):
        np.testing.assert_array_equal(getattr(fr, f), ref["fr_" + f], err_msg=f)
    np.testing.assert_array_equal(fr.desc, ref["desc"])
    q = fr.qual_score[fr.valid]
    assert len(np.unique(q)) > 50 and q.min() >= 0.0 and q.max() <= 1.0
    assert (fr.depth > 0).sum() > 50
    h = fe.submit(left, right, torch.from_numpy(cost))
    np.testing.assert_array_equal(h.host_pack.numpy(), ref["host_pack"])


def test_attached_fcn_equals_explicit_cost_map(world_frame):
    """tests/test_fcn.py::test_frontend_fused_fcn on the port: the frontend
    with an FCN attached gives the Frame that the FCN's own cost map, passed
    explicitly, gives; quality is seeded in [-1, 1]."""
    from iv_slam_tpu_torch.models import IntrospectionNet, inference_cost_map

    cfg, _, left, right = world_frame
    torch.manual_seed(0)
    net = IntrospectionNet()
    fe = StereoFrontend(cfg, left.shape[0], left.shape[1], device="cpu")
    fe.attach_introspection(net, net_hw=(64, 64))
    fr = fe.process(left, right, 0.0)
    cost = inference_cost_map(net, torch.from_numpy(np.stack([left] * 3, axis=-1)),
                              left.shape, (64, 64))
    fr2 = StereoFrontend(cfg, left.shape[0], left.shape[1], device="cpu").process(
        left, right, 0.0, cost_map=cost)
    q = fr.qual_score[fr.valid]
    assert len(q) > 50 and (q >= -1.0).all() and (q <= 1.0).all()
    for f in ("xy", "octave", "valid", "u_right", "depth", "qual_score"):
        np.testing.assert_array_equal(getattr(fr, f), getattr(fr2, f), err_msg=f)
    np.testing.assert_array_equal(fr.desc, fr2.desc)
    # an explicit cost map takes precedence over the attached FCN
    fr3 = fe.process(left, right, 1.0, cost_map=np.zeros_like(left))
    fr4 = StereoFrontend(cfg, left.shape[0], left.shape[1], device="cpu").process(
        left, right, 1.0, cost_map=np.zeros_like(left))
    np.testing.assert_array_equal(fr3.xy, fr4.xy)


def test_unported_frontend_paths_raise(world_frame):
    """What stays refused around the frontend: a cost map that is not an
    (H, W) uint8 map."""
    cfg, _, left, right = world_frame
    fe = StereoFrontend(cfg, left.shape[0], left.shape[1], device="cpu")
    with pytest.raises(ValueError, match="uint8"):
        fe.process(left, right, 0.0, cost_map=np.zeros(left.shape, np.float32))
    with pytest.raises(ValueError, match="uint8"):
        fe.process(left, right, 0.0, cost_map=np.zeros((8, 8), np.uint8))


def test_default_device_needs_cuda(world_frame, monkeypatch):
    cfg, _, left, _ = world_frame
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StereoFrontend(cfg, left.shape[0], left.shape[1])


def _port_config_from(d: dict) -> tconfig.Config:
    return tconfig.Config(**{
        f.name: f.default_factory(**d[f.name])
        for f in dataclasses.fields(tconfig.Config)
    })


def test_config_round_trips_with_jax_package():
    j = jconfig.Config()
    j.orb.n_features, j.orb.ini_th_fast, j.camera.bf = 1500, 20, 123.5
    j.system.link_rtt_ms = 12.0
    d = dataclasses.asdict(j)
    assert dataclasses.asdict(_port_config_from(d)) == d
    assert dataclasses.asdict(tconfig.Config()) == dataclasses.asdict(jconfig.Config())
    ref_yaml = os.path.join(REPO, "settings", "KITTI00-02.yaml")
    assert (dataclasses.asdict(tconfig.load_reference_yaml(ref_yaml))
            == dataclasses.asdict(jconfig.load_reference_yaml(ref_yaml)))
    for a, b in zip(tconfig.ORBConfig().features_per_level(),
                    jconfig.ORBConfig().features_per_level()):
        assert a == b


def test_brief_pattern_file_is_a_copy():
    with open(os.path.join(REPO, "iv_slam_tpu", "ops", "brief_pattern.npy"), "rb") as f:
        a = f.read()
    with open(os.path.join(REPO, "iv_slam_tpu_torch", "ops", "brief_pattern.npy"), "rb") as f:
        b = f.read()
    assert a == b
