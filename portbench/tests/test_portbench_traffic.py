"""The frozen traffic generators: the same seed gives the same frames,
samples and weights; other seeds and other sessions give other ones; the
circuit closes with no jump in motion."""

import numpy as np
import torch

from portbench.reference import fcn as ref
from portbench.traffic import circuit, samples, seeds, weights, world

ARCH = dict(stem_channels=32, inverted_residual_setting=[[1, 16, 1, 1], [6, 24, 2, 2]],
            dilate_from=[7, 14], fc_dim=320, num_class=1)


def _frames(seed, session):
    w = world.PlaneWorld(seeds.rng(seed, 300, session), tex_size=256, res=20.0, w=64, h=48,
                         fx=60.0, fy=60.0, cx=32.0, cy=24.0)
    return w.render_stereo(world.camera_pose(np.array([1.0, 0.5, 0.0], np.float32), 5.0, 0.1))


def test_frames_repeat_for_a_seed_and_differ_across_seeds_and_sessions():
    a = _frames(2 ** 31 + 7, 0)
    assert all(np.array_equal(x, y) for x, y in zip(a, _frames(2 ** 31 + 7, 0)))
    assert not np.array_equal(a[0], _frames(2 ** 31 + 8, 0)[0])
    assert not np.array_equal(a[0], _frames(2 ** 31 + 7, 1)[0])
    assert not np.array_equal(a[0], a[1])      # the right view is displaced


def test_circuit_closes_without_a_jump():
    n, v_min, v_max = 100, 0.1, 0.8
    lap = circuit.lap(n, v_min, v_max, 4.0, 15.0, 0.01, 3)
    c = np.array([p[:3, 3] for p in lap], np.float64)
    ring = np.vstack([c, c[:2]])               # the next lap starts where this one did
    steps = np.diff(ring, axis=0)
    speed = np.linalg.norm(steps, axis=1)
    assert speed.min() > 0.95 * v_min and speed.max() < 1.01 * v_max
    # the step from the last pose into the first is the speed profile's own
    assert abs(speed[n - 1] - circuit.speeds(n, v_min, v_max)[n - 1]) < 1e-3
    # no jump in motion: the change of velocity across the seam is as small
    # as anywhere else on the lap
    accel = np.linalg.norm(np.diff(steps, axis=0), axis=1)
    assert accel[n - 2] <= accel.max() and accel[n - 1] <= accel.max()
    assert accel[n - 2] < 0.05 and accel[n - 1] < 0.05
    yaw = [np.arctan2(p[1, 0], p[0, 0]) for p in lap]
    assert abs(yaw[0]) < 1e-6 and abs(yaw[-1]) < 0.01 * 2 * np.pi * 3 / n + 1e-6
    assert np.allclose(lap[0][2, 3], 15.0)


def test_samples_and_weights_repeat_and_differ():
    dev = torch.device("cpu")
    p1, p2 = (samples.fcn_pool(s, 4, (32, 32), dev) for s in (5, 6))
    again = samples.fcn_pool(5, 4, (32, 32), dev)
    for k in ("image", "target", "mask"):
        assert torch.equal(p1[k], again[k]) and not torch.equal(p1[k], p2[k])
    assert p1["target"].shape == (4, 4, 4, 1) and set(p1["mask"].unique().tolist()) <= {0.0, 1.0}
    assert 0.0 <= float(p1["target"].min()) and float(p1["target"].max()) <= 1.0
    r = samples.colour_ring(5, 3, (24, 40), dev)
    assert r.dtype == torch.uint8 and r.shape == (3, 24, 40, 3)
    assert torch.equal(r, samples.colour_ring(5, 3, (24, 40), dev))
    assert not torch.equal(r[0], r[1])
    shapes = ref.param_shapes(ARCH)
    w1, w2 = weights.fcn_weights(shapes, 5, dev), weights.fcn_weights(shapes, 6, dev)
    assert all(torch.equal(w1[k], v) for k, v in weights.fcn_weights(shapes, 5, dev).items())
    assert not torch.equal(w1["encoder.features.0.0.weight"], w2["encoder.features.0.0.weight"])
    assert float(w1["encoder.features.0.1.running_var"].min()) >= 0.5


def test_every_seed_deals_the_same_worlds():
    from portbench.drivers.track import world_of

    for seed in (1, 2 ** 31 + 11, 2 ** 33):
        assert sorted(world_of(seed, k, 6) for k in range(6)) == list(range(6))
    assert [world_of(5, k, 6) for k in range(6)] != [world_of(6, k, 6) for k in range(6)]


def test_child_seeds_take_any_whole_number():
    a = seeds.child(2 ** 33 + 5, 1)
    assert a == seeds.child(2 ** 33 + 5, 1) and a != seeds.child(2 ** 33 + 5, 2)
    assert 0 <= a < 2 ** 63
