"""Port parity: slam/map_store.py (the port's copy) and slam/device_map.py
against the JAX package.

The same MapStore mutations run on the reference's store and the port's;
after each, both DeviceMaps sync and every table must be equal: a full
splice at the first live rung, delta scatters padded to the 256 and 1024
row buckets, a dirty set above the top bucket, and rung changes to 4096
and 16384. The port's syncs build new tensors: views taken before a sync
keep their values.
"""

import types

import numpy as np
import pytest
import torch

from iv_slam_tpu.slam import device_map as jdm
from iv_slam_tpu.slam import map_store as jms
from iv_slam_tpu_torch.config import Config
from iv_slam_tpu_torch.slam import device_map as tdm
from iv_slam_tpu_torch.slam import fused_track as tft
from iv_slam_tpu_torch.slam import map_store as tms

STORE_FIELDS = ("pt_pos", "pt_desc", "pt_normal", "pt_min_dist", "pt_max_dist",
                "pt_alive", "pt_quality", "pt_visible", "pt_found", "pt_first_kf",
                "pt_ref_kf", "pt_n_obs", "_dirty", "kf_pose", "kf_alive")


def fake_frame(rng, i, n=3000):
    """What MapStore reads of a keyframe's frame."""
    c, s = np.cos(0.05 * i), np.sin(0.05 * i)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    pose[:3, 3] = [0.3 * i, 0.1, -0.5 * i]
    return types.SimpleNamespace(
        pose=pose, frame_id=i, timestamp=0.1 * i, gt_pose=None, img_name=f"{i}",
        u_right=np.where(rng.uniform(size=n) < 0.6, rng.uniform(0, 300, n), -1.0)
        .astype(np.float32),
        desc=rng.integers(0, 256, (n, 32), dtype=np.uint8),
        octave=rng.integers(0, 8, n).astype(np.int32),
        map_pt=np.full(n, -1, np.int32))


class Twin:
    """The reference's and the port's MapStore + DeviceMap, mutated alike."""

    def __init__(self):
        self.stores = (jms.MapStore(max_points=20000, max_keyframes=16),
                       tms.MapStore(max_points=20000, max_keyframes=16))
        self.maps = (jdm.DeviceMap(), tdm.DeviceMap(device="cpu"))

    def __getattr__(self, name):
        """Call a MapStore method on both stores."""
        def both(*args):
            outs = [getattr(s, name)(*args) for s in self.stores]
            assert np.array_equal(outs[0], outs[1]) if isinstance(outs[0], np.ndarray) \
                else outs[0] == outs[1], (name, outs)
            return outs[1]
        return both

    def sync(self, force=False):
        for s, m in zip(self.stores, self.maps):
            m.sync(s, force)
        self.check()

    def check(self):
        js, ts = self.stores
        for f in STORE_FIELDS:
            np.testing.assert_array_equal(getattr(ts, f), getattr(js, f), err_msg=f)
        assert ts.pt_obs[:ts.n_points] == js.pt_obs[:js.n_points]
        jm, tm = self.maps
        assert tm.live_cap == jm.live_cap
        for a, b in zip(tm.live_views() + tm.full_views(), jm.live_views() + jm.full_views()):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def add_points(tw, rng, kf, frame, n):
    feats = rng.choice(len(frame.desc), n, replace=False)
    pids = []
    for f in feats:
        pid = tw.add_point(rng.normal(size=3).astype(np.float32) * 5 + [0, 0, 10], kf,
                           float(rng.uniform(0.5, 1.0)))
        tw.add_observation(pid, kf, int(f))
        frame.map_pt[f] = pid
        pids.append(pid)
    return pids


def test_map_store_and_device_map_sync_match_jax(monkeypatch):
    paths = []
    for name in ("_splice", "_scatter"):
        fn = getattr(tdm, name)
        monkeypatch.setattr(tdm, name, lambda *a, _fn=fn, _n=name: (
            paths.append((_n, a[-1].shape[0])), _fn(*a))[1])

    def sync(path, rows, force=False):
        paths.clear()
        tw.sync(force)
        assert paths == [(path, rows)]

    rng = np.random.default_rng(5)
    tw = Twin()
    frames = [fake_frame(np.random.default_rng(i), i) for i in range(4)]
    kfs = [tw.add_keyframe(f) for f in frames]
    pids = add_points(tw, rng, kfs[0], frames[0], 600)
    for p in pids[:300]:  # a second observation for half of them
        tw.add_observation(p, kfs[1], int(rng.integers(0, 3000)))
    for p in pids:
        tw.compute_distinctive_descriptor(p)
        tw.update_normal_and_depth(p)
    sync("_splice", 1024)                       # full splice at rung 1024

    old = [v.clone() for v in tw.maps[1].live_views()]
    held = tw.maps[1].live_views()
    for p in pids[:40]:
        tw.kill_point(p)
    tw.compute_distinctive_descriptor_batch(pids[300:400])
    sync("_scatter", 256)                       # 140 dirty rows: 256 bucket
    for a, b in zip(held, old):                 # the held views did not change
        assert torch.equal(a, b)
    assert not torch.equal(tw.maps[1].live_views()[-1], old[-1])

    tw.update_normal_and_depth_batch(pids[100:600])
    sync("_scatter", 1024)                      # 460 live rows: 1024 bucket
    tw.add_points_batch(rng.normal(size=(900, 3)).astype(np.float32), kfs[2], 0.7)
    sync("_splice", 4096)                       # 1500 points: rung 4096
    for i in range(3):
        tw.erase_observation(pids[300 + i], kfs[0])
    tw.retire_point(pids[310])
    sync("_scatter", 256)
    add_points(tw, rng, kfs[3], frames[3], 2800)
    tw.add_points_batch(rng.normal(size=(1000, 3)).astype(np.float32), kfs[3])
    sync("_splice", 16384)                      # 5300 points: rung 16384
    tw.mark_dirty(np.arange(0, 4500))
    sync("_splice", 16384)                      # > 4096 dirty rows: full splice
    tw.mark_dirty(np.arange(0, 3000))
    sync("_scatter", 4096)
    tw.mark_dirty(np.arange(0, 10))
    sync("_splice", 16384, force=True)
    assert tw.stores[1].covisible_keyframes(kfs[0]) == tw.stores[0].covisible_keyframes(kfs[0])


def test_scatter_drops_padded_rows():
    cap = 8
    packed = torch.arange(cap * 9, dtype=torch.float32).reshape(cap, 9)
    desc = torch.arange(cap * 32, dtype=torch.int64).to(torch.uint8).reshape(cap, 32)
    valid = torch.ones(cap, dtype=torch.bool)
    idx = torch.tensor([5, 1, cap, cap, cap])
    rows_p = -torch.ones(5, 9)
    rows_d = torch.zeros(5, 32, dtype=torch.uint8)
    rows_v = torch.zeros(5, dtype=torch.bool)
    p2, d2, v2 = tdm._scatter(packed, desc, valid, idx, rows_p, rows_d, rows_v)
    assert p2.shape == packed.shape and d2.shape == desc.shape and v2.shape == valid.shape
    want_p = packed.clone()
    want_p[[5, 1]] = -1
    assert torch.equal(p2, want_p)
    assert torch.equal(v2, torch.tensor([1, 0, 1, 1, 1, 0, 1, 1], dtype=torch.bool))
    assert torch.equal(d2[[0, 2, 3, 4, 6, 7]], desc[[0, 2, 3, 4, 6, 7]])
    assert torch.equal(packed, torch.arange(cap * 9, dtype=torch.float32).reshape(cap, 9))


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdm.DeviceMap()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tft.FusedTracker(Config(), 240, 320)
