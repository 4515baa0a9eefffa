"""The plain reference against the system under test on the CPU, at small
sizes: the FCN's prediction, cost map and training step, and the ORB
stereo frontend bit for bit; and the controls that the checks must
refuse."""

import json
import os

import numpy as np
import pytest
import torch

from portbench.drivers import common
from portbench.reference import fcn as ref
from portbench.reference.orb.config import ORBConfig
from portbench.reference.orb.frontend import StereoFrontend as RefFrontend
from portbench.reference.trajectory import ate_rmse
from portbench.traffic import samples, weights, world

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = json.load(open(os.path.join(HERE, "configs", "kitti_iv_stereo.json")))
ARCH = CFG["fcn"]
CPU = torch.device("cpu")


def _nets(seed=3):
    from iv_slam_tpu_torch import models

    w = weights.fcn_weights(ref.param_shapes(ARCH), seed, CPU)
    net = models.IntrospectionNet()
    sd = net.state_dict()
    sd.update(w)
    net.load_state_dict(sd)
    return net.eval(), w


def test_reference_keys_are_the_networks():
    from iv_slam_tpu_torch import models

    keys = {k for k in models.IntrospectionNet().state_dict() if not k.endswith("tracked")}
    assert keys == set(ref.param_shapes(ARCH))


def test_prediction_and_cost_map_match_the_port():
    from iv_slam_tpu_torch import models

    net, w = _nets()
    p, stats = common.split(w)
    img = samples.colour_ring(4, 2, (48, 80), CPU)
    got = models.predict(net, img, (64, 64))
    want = ref.predict(ARCH, p, stats, img, (64, 64))
    # ~50 float32 layers in another form (BatchNorm as a product and a sum,
    # not ATen's kernel) with seeded weights: round-off of ~1e-5 of the
    # output's scale
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    d = (models.inference_cost_map(net, img, (48, 80), (64, 64)).int()
         - ref.cost_map(ARCH, p, stats, img, (48, 80), (64, 64)).int()).abs()
    assert int(d.max()) <= 1


def test_a_training_step_matches_the_port():
    from iv_slam_tpu_torch.train.trainer import TrainConfig, Trainer

    recipe = dict(lr=0.02, momentum=0.9, weight_decay=1e-4, lr_pow=0.9, deep_sup_scale=0.4,
                  num_epochs=20)
    tr = Trainer(TrainConfig(input_hw=(64, 64), batch_size=4), device="cpu")
    w = weights.fcn_weights(ref.param_shapes(ARCH), 5, CPU)
    sd = tr.net.state_dict()
    sd.update(w)
    tr.net.load_state_dict(sd)
    pool = samples.fcn_pool(5, 4, (64, 64), CPU)
    out = tr.step({k: v.numpy() for k, v in pool.items()})
    feed = [tuple(pool[k].permute(0, 3, 1, 2) for k in ("image", "target", "mask"))]
    r = ref.train_steps(ARCH, recipe, w, feed)
    assert abs(float(out["loss"]) - r["loss"][0]) <= 1e-6 * abs(r["loss"][0])
    opt = tr.state.optimizer
    for k, prm in tr.net.named_parameters():
        got, want = opt.state[prm]["momentum_buffer"], r["update"][k]
        assert torch.allclose(got, want, rtol=1e-3, atol=1e-6 * float(want.abs().max()) + 1e-12)
        assert torch.allclose(prm.detach(), r["params"][k], rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("weighted", [False, True])
def test_the_frontend_matches_the_port_bit_for_bit(weighted):
    from iv_slam_tpu_torch.config import CameraConfig, Config, ORBConfig as PortORB
    from iv_slam_tpu_torch.slam.frame import StereoFrontend

    h, w = 120, 200
    scene = world.PlaneWorld(np.random.default_rng(2), tex_size=512, res=30.0, fx=150.0,
                             fy=150.0, cx=100.0, cy=60.0, w=w, h=h, baseline=0.5)
    left, right = scene.render_stereo(world.camera_pose(np.array([1.0, 2.0, 0.0], np.float32),
                                                        6.0, 0.2))
    cost = (torch.from_numpy(samples.colour_ring(1, 1, (h, w), CPU)[0, ..., 0].numpy())
            if weighted else None)
    cfg = Config()
    cfg.camera = CameraConfig(fx=150.0, fy=150.0, cx=100.0, cy=60.0, bf=75.0, width=w,
                              height=h)
    cfg.orb = PortORB(n_features=500, n_levels=4, ini_th_fast=12, min_th_fast=7)
    fe = StereoFrontend(cfg, h, w, device="cpu")
    got = fe.submit(left, right, cost)
    mine = RefFrontend(ORBConfig(500, 1.2, 4, 12, 7), cfg.camera, h, w, CPU).frame(
        torch.from_numpy(np.stack([left, right])), cost)
    for a, b in zip(got.kl + got.kr, mine.kl + mine.kr):
        assert torch.equal(a, b)
    for k, v in (("u_right", mine.u_right), ("depth", mine.depth), ("qual", mine.qual)):
        assert torch.equal(getattr(got, k), v)
    assert int(got.kl.valid.sum()) > 100 and int((mine.depth > 0).sum()) > 50


def test_the_tf32_control_fails_the_cost_map_limits():
    """The control of both cost-map cells: the reference with TF32's
    operands (emulated on the CPU) against the float32 reference."""
    net, w = _nets(7)
    p, stats = common.split(w)
    img = samples.colour_ring(7, 2, (96, 160), CPU)
    gap = common.MapGap()
    gap.add(ref.cost_map(ARCH, p, stats, img, (96, 160), (64, 64), "tf32"),
            ref.cost_map(ARCH, p, stats, img, (96, 160), (64, 64)))
    lim = json.load(open(os.path.join(HERE, "workloads", "costmap.kitti.json")))["limits"]
    assert gap.worst > lim["cost_max_diff"] or gap.share > lim["cost_diff_share"]


def test_the_tf32_control_fails_a_training_limit():
    from portbench.drivers import train as tr

    recipe = dict(lr=0.02, momentum=0.9, weight_decay=1e-4, lr_pow=0.9, deep_sup_scale=0.4,
                  num_epochs=20)
    w = weights.fcn_weights(ref.param_shapes(ARCH), 9, CPU)
    pool = samples.fcn_pool(9, 12, (64, 64), CPU)
    feed = [tuple(pool[k][i:i + 4].permute(0, 3, 1, 2) for k in ("image", "target", "mask"))
            for i in (0, 4, 8)]
    r32 = ref.train_steps(ARCH, recipe, w, feed)
    got = tr.compare(ref.train_steps(ARCH, recipe, w, feed, "tf32"), r32, w)
    lim = json.load(open(os.path.join(HERE, "workloads", "train.fcn_b8.json")))["limits"]
    assert any(got[k] > lim[k] for k in lim)


def test_ate_is_zero_under_a_rigid_motion_and_grows_with_noise():
    rng = np.random.default_rng(0)
    gt = np.stack([world.camera_pose(rng.normal(size=3).astype(np.float32), 10.0, 0.1 * i)
                   for i in range(20)])
    T = world.camera_pose(np.array([3.0, -1.0, 0.0], np.float32), 2.0, 0.7)
    est = np.stack([T @ g for g in gt])
    assert ate_rmse(est, gt) < 1e-5
    est[:, :3, 3] += rng.normal(scale=0.1, size=(20, 3))
    assert 0.05 < ate_rmse(est, gt) < 0.2
    with pytest.raises(ValueError):
        ate_rmse(est[:5], gt)
