"""Port parity: the reference's thread architecture (ROADMAP A7), the
LocalMapping worker (slam/local_mapping.py ``start_worker`` ...
``stop_worker``) and the async local BA (solvers/local_ba.py
``LBAHandle``, ``local_bundle_adjustment_async``, ``apply_local_ba``), on
the CPU path at tests/test_torch_system.py's size (320x240, 800 features,
4 levels).

* The merge of an async local BA equals the synchronous local BA on the
  same map, bit for bit, whether the worker drives its segments or the
  helper thread solves it.
* Between dispatch and merge a window point is killed, another's
  observation moves to another feature, and a window keyframe is culled:
  the port's ``_apply_local_ba_data`` leaves the map as the JAX package's
  does on the same map with the same result (exactly), and both keep the
  newer state.
* ``_trim_window``: tests/test_prewarm.py's two cases on the port, and the
  JAX function's output on the same windows.
* The worker's lifecycle (tests/test_threaded_mapping.py::
  test_worker_lifecycle) and its exception, raised at the next ``join``.
* The busy-mapper gate and its starvation guard: with a stubbed
  ``pending_count``, the port's ``_need_new_keyframe`` decides as the JAX
  package's on the same frame and map.
* Threads racing to merge one pending local or global BA merge it once.
* A threaded, async run has processed and merged every event when its
  trajectory is read.
* Slow (the ports of the reference's slow tests; ``chip_smoke.py`` phase 14
  covers them on the card): the threaded and async configurations track
  like the synchronous one.

The serialized worker (each event waited for) against the inline run and
the JAX System is in tests/test_torch_system.py, beside the JAX runs it
shares.
"""

import types

import numpy as np
import pytest
import torch

import synth_world
from iv_slam_tpu_torch.io import trajectory
from iv_slam_tpu_torch.slam.map_store import MapStore
from iv_slam_tpu_torch.slam.system import System
from iv_slam_tpu_torch.slam.tracking import State
from iv_slam_tpu_torch.solvers import local_ba
from test_torch_system import make_config
from torch_parity import dump_map, one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")


def run(cfg, frames, kf_every=0):
    """A System over the frames, a keyframe forced at the end of every
    kf_every frames (tests/test_ba_variants.py's loop)."""
    s = System(cfg, 240, 320, device="cpu")
    tr = s.tracking
    for i, (left, right) in enumerate(frames):
        s.track_stereo(left, right, timestamp=i * 0.1)
        if (kf_every and i % kf_every == kf_every - 1 and s.state == State.OK
                and tr.current.frame_id != tr.last_kf_frame_id):
            tr._create_new_keyframe()
    return s


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """A 4-keyframe map (a keyframe forced every third frame) saved to
    disk, its system and its last keyframe."""
    _, frames, _ = synth_world.make_sequence(np.random.default_rng(7), n_frames=10, step=0.08)
    s = run(make_config(fused=True), frames, kf_every=3)
    m = s.tracking.map
    assert m.n_keyframes >= 4
    path = str(tmp_path_factory.mktemp("threads") / "map.npz")
    m.save(path)
    return s, path, m.n_keyframes - 1


def load(path):
    return MapStore.load(path, n_levels=4, scale_factor=1.2)


def same_maps(a, b):
    da, db = dump_map(a), dump_map(b)
    assert da.keys() == db.keys()
    for k in da:
        np.testing.assert_array_equal(da[k], db[k], err_msg=k)


@pytest.mark.parametrize("segmented", [True, False], ids=["worker segments", "helper thread"])
def test_async_merge_equals_sync_local_ba(session, segmented):
    from concurrent.futures import ThreadPoolExecutor

    s, path, kf_id = session
    cfg = s.cfg
    sync, asy = load(path), load(path)
    rung = local_ba.local_bundle_adjustment(cfg, sync, kf_id, torch.device("cpu"))
    with ThreadPoolExecutor(max_workers=1) as pool:
        h = local_ba.local_bundle_adjustment_async(cfg, asy, kf_id, torch.device("cpu"),
                                                   segmented=segmented, executor=pool)
        assert h.rung == rung
        if segmented:
            assert not h.is_ready()
            h.drive()
        local_ba.apply_local_ba(h, asy)
        assert h.is_ready()
    same_maps(sync, asy)
    # the merge moved the window
    assert not np.array_equal(load(path).kf_pose[kf_id], asy.kf_pose[kf_id])


def jax_map(d, n_levels=4):
    """The JAX package's MapStore equal to a dumped one (frames as plain
    records of their arrays: the merge reads nothing else)."""
    from iv_slam_tpu.slam.map_store import MapStore as JaxMapStore

    m = JaxMapStore(n_levels=n_levels, scale_factor=1.2)
    n, k = len(d["pt_pos"]), len(d["kf_pose"])
    m.n_points, m.n_keyframes = n, k
    for f in ("pt_pos", "pt_desc", "pt_normal", "pt_min_dist", "pt_max_dist", "pt_alive",
              "pt_quality", "pt_visible", "pt_found", "pt_first_kf", "pt_ref_kf",
              "pt_n_obs", "kf_pose", "kf_alive", "kf_frame_id", "kf_timestamp"):
        getattr(m, f)[: len(d[f])] = d[f]
    m.origin_kf = int(d["origin_kf"])
    for p, kf, feat in d["obs"]:
        m.pt_obs[int(p)][int(kf)] = int(feat)
    for i in range(k):
        m.kf_frames[i] = types.SimpleNamespace(
            pose=d["kf_pose"][i].copy(),
            **{f: d["fr_" + f][i].copy() for f in ("xy", "octave", "angle", "desc", "valid",
                                                     "u_right", "depth", "qual_score",
                                                     "map_pt")})
    return m


def test_merge_revalidates_like_jax(session):
    """A point killed, an observation moved to another feature and a
    keyframe culled between dispatch and merge: both packages' merges leave
    the same map, and it keeps the newer state."""
    from iv_slam_tpu.solvers import local_ba as jax_lba

    s, path, kf_id = session
    m = load(path)
    h = local_ba.local_bundle_adjustment_async(s.cfg, m, kf_id, torch.device("cpu"))
    poses, pts, inlier, chi2 = h.result()
    e_feat = h.e_feat
    # the changes, made on the port's map through its MapStore
    by_n_obs = sorted(h.pts, key=lambda p: -m.n_observations(p))
    killed, moved = by_n_obs[0], by_n_obs[1]
    m.kill_point(killed)
    e_moved = next(i for i, (p, k, f) in enumerate(e_feat) if p == moved and k != kf_id)
    _, k_moved, f_old = e_feat[e_moved]
    fr = m.kf_frames[k_moved]
    f_new = int(np.nonzero(fr.valid & (fr.map_pt < 0))[0][0])
    m.erase_observation(moved, k_moved)
    fr.map_pt[f_old] = -1
    m.add_observation(moved, k_moved, f_new)
    fr.map_pt[f_new] = moved
    culled = next(k for i, k in enumerate(h.all_kfs[: h.n_local])
                  if k != kf_id and not h.kf_fixed[i])
    m.kf_alive[culled] = False
    # outliers: the moved edge, the killed point's edges and 20 others
    inlier = inlier.copy()
    inlier[e_moved] = False
    inlier[[i for i, (p, _, _) in enumerate(e_feat) if p == killed]] = False
    others = [i for i, (p, _, _) in enumerate(e_feat) if p not in (killed, moved)]
    inlier[others[::max(len(others) // 20, 1)][:20]] = False
    before = dump_map(m)

    jm = jax_map(before)
    with m.lock:
        local_ba._apply_local_ba_data(h, m, poses, pts, inlier, chi2)
    jax_lba._apply_local_ba_data(h, jm, poses, pts, inlier, chi2)
    got, want = dump_map(m), dump_map(jm)
    for k in ("pt_pos", "pt_normal", "pt_min_dist", "pt_max_dist", "pt_alive", "pt_n_obs",
              "pt_ref_kf", "kf_pose", "kf_alive", "obs", "fr_map_pt"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the newer state stands: the killed point did not move, the moved
    # observation stayed, the culled keyframe kept its pose
    np.testing.assert_array_equal(got["pt_pos"][killed], before["pt_pos"][killed])
    assert m.pt_obs[moved].get(k_moved) == f_new
    np.testing.assert_array_equal(got["kf_pose"][culled], before["kf_pose"][culled])
    # and the rest merged: the 20 other outliers erased, the new keyframe moved
    assert (got["obs"].shape[0] < before["obs"].shape[0])
    assert not np.array_equal(got["kf_pose"][kf_id], before["kf_pose"][kf_id])


class _FakeFrame:
    def __init__(self, pids):
        self.map_pt = np.asarray(pids, np.int64)


class _FakeMap:
    """Just enough MapStore surface for _trim_window (tests/test_prewarm.py)."""

    def __init__(self, pts_per_kf):
        self.kf_frames = {k: _FakeFrame(p) for k, p in enumerate(pts_per_kf)}
        self._obs = {}
        for k, pids in enumerate(pts_per_kf):
            for p in pids:
                self._obs.setdefault(int(p), set()).add(k)

    def n_observations(self, pid):
        return len(self._obs.get(int(pid), ()))


def test_trim_window_caps_oversized_windows():
    from iv_slam_tpu.solvers.local_ba import _trim_window as jax_trim

    max_kf, max_pt, _ = local_ba.LBA_RUNGS[-1]
    n_kf = max_kf + 40
    rng = np.random.default_rng(0)
    # 120 points per keyframe drawn from a pool 2x the point cap
    pts_per_kf = [rng.choice(max_pt * 2, 120, replace=False) for _ in range(n_kf)]
    m = _FakeMap(pts_per_kf)
    local = list(range(40))                      # fits (below cap - 8)
    fixed = list(range(40, n_kf))                # overflows the kf budget
    pts = sorted({int(p) for row in pts_per_kf for p in row})

    tl, tf, tp = local_ba._trim_window(m, local, fixed, pts)
    assert (tl, tf, tp) == jax_trim(m, local, fixed, pts)
    assert tl == local                            # local window untouched
    assert len(tl) + len(tf) <= max_kf
    assert len(tp) <= max_pt
    # kept fixed keyframes anchor at least as many window points as any
    # dropped one
    window = set(pts)

    def score(k):
        return sum(1 for p in m.kf_frames[k].map_pt if int(p) in window)

    dropped = [k for k in fixed if k not in set(tf)]
    assert dropped and min(score(k) for k in tf) >= max(score(k) for k in dropped)


def test_trim_window_noop_when_small():
    m = _FakeMap([np.arange(10) for _ in range(4)])
    local, fixed, pts = [0, 1], [2, 3], list(range(10))
    assert local_ba._trim_window(m, local, fixed, pts) == (local, fixed, pts)


def threaded_config(asy=True):
    cfg = make_config(fused=True)
    cfg.system.threaded_local_mapping = True
    cfg.system.async_local_ba = asy
    return cfg


def test_worker_lifecycle():
    """start, join, reset and shutdown re-arm and stop the worker; a failed
    event is raised at the next join, once."""
    s = System(threaded_config(), 240, 320, device="cpu")
    lm = s.tracking.local_mapping
    thread = lm._worker
    assert thread is not None and thread.is_alive()
    assert lm.pending_count() == 0
    lm.join()
    s.tracking._reset()
    lm2 = s.tracking.local_mapping
    assert lm2 is not lm
    assert lm2._worker is not None and lm2._worker.is_alive()
    assert lm._worker is None and not thread.is_alive()   # the old worker stopped

    def fail(kf_id, run_ba=True):
        raise RuntimeError(f"event {kf_id} failed")

    lm2._process_one = fail
    lm2.queue.append(7)
    lm2.kick_async()
    with pytest.raises(RuntimeError, match="event 7 failed"):
        lm2.join()
    assert lm2.worker_exc is None and lm2.pending_count() == 0
    lm2.join()                              # raised once
    assert lm2.poll_map_changed() and not lm2.poll_map_changed()
    thread = lm2._worker
    s.shutdown()
    assert lm2._worker is None and not thread.is_alive()


@pytest.mark.parametrize("what", ["local BA", "global BA"])
def test_one_merge_per_handle_under_contention(monkeypatch, what):
    """Threads racing to merge one pending result (tracking's per-frame
    poll, the worker's forced join, its loop-closing hook) merge it once:
    the handle is taken under the map lock. 8 threads, a 1 us switch
    interval, 100 rounds."""
    import sys
    import threading

    from iv_slam_tpu_torch.slam import local_mapping, loop_closing
    from iv_slam_tpu_torch.slam.local_mapping import LocalMapping

    merged = []
    monkeypatch.setattr(local_mapping.local_ba, "apply_local_ba",
                        lambda h, m: merged.append(h))
    monkeypatch.setattr(loop_closing, "apply_global_ba", lambda h, m: merged.append(h))
    cfg = make_config()
    m = MapStore(n_levels=4, scale_factor=1.2)
    lm = LocalMapping(cfg, m, "cpu")
    lc = types.SimpleNamespace(map=m, pending_gba=None)
    ready = types.SimpleNamespace(is_ready=lambda: True)
    if what == "local BA":
        def merge():
            return lm.apply_pending_ba(only_if_ready=True)
    else:
        def merge():
            return loop_closing.LoopClosing.collect_gba(lc, only_if_ready=True)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for r in range(100):
            h = types.SimpleNamespace(is_ready=ready.is_ready, round=r)
            lm._pending_ba = lc.pending_gba = h
            wins = []
            start = threading.Barrier(8)

            def race():
                start.wait(timeout=10)
                wins.append(merge())

            threads = [threading.Thread(target=race) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=10)
            assert not any(t.is_alive() for t in threads)
            assert wins.count(True) == 1 and len(wins) == 8
            assert [x.round for x in merged] == list(range(r + 1))
    finally:
        sys.setswitchinterval(old)


class _StubMapping:
    def __init__(self, pending, worker):
        self._worker = worker
        self._pending = pending

    def pending_count(self):
        return self._pending


@pytest.mark.parametrize("worker", [True, False], ids=["worker", "inline"])
@pytest.mark.parametrize("pending", [0, 2, 3, 5, 6, 8])
@pytest.mark.parametrize("gap", ["short", "max_frames"])
def test_busy_mapper_gate_matches_jax(session, worker, pending, gap):
    from iv_slam_tpu.slam.tracking import Tracking as JaxTracking

    from iv_slam_tpu_torch.slam.tracking import Tracking

    s, _, _ = session
    tr = s.tracking
    frame = tr.current
    max_frames = tr.max_frames
    fake = types.SimpleNamespace(
        cfg=tr.cfg, map=tr.map, current=frame, ref_kf=tr.ref_kf, min_frames=0,
        max_frames=max_frames, n_inliers=16,
        last_kf_frame_id=frame.frame_id - (2 if gap == "short" else max_frames),
        local_mapping=_StubMapping(pending, object() if worker else None))
    got = Tracking._need_new_keyframe(fake)
    assert got == JaxTracking._need_new_keyframe(fake)
    busy = worker and pending >= 3 and (gap == "short" or pending >= 6)
    assert got == (not busy)


def test_async_threads_finish_their_work(session):
    """Every event of a threaded, async run is processed and merged by the
    trajectory read; shutdown stops the worker."""
    _, frames, _ = synth_world.make_sequence(np.random.default_rng(7), n_frames=8, step=0.08)
    s = run(threaded_config(), frames, kf_every=3)
    lm = s.tracking.local_mapping
    s.trajectory_twc()
    assert lm.pending_count() == 0 and lm._pending_ba is None and lm.worker_exc is None
    assert len(lm.ba_rungs) >= 1
    s.shutdown()
    assert lm._worker is None


# ---- the reference's slow tests on the port ----------------------------


@pytest.mark.slow
def test_threaded_matches_sync(rng):
    """tests/test_threaded_mapping.py::test_threaded_matches_sync: 0.35 m a
    frame makes keyframes; the threaded run tracks like the inline one."""
    _, frames, gt = synth_world.make_sequence(rng, n_frames=16, step=0.35)

    def one(threaded):
        s = run(threaded_config() if threaded else make_config(fused=True), frames)
        assert s.state == State.OK and s.failure_count == 0
        est = s.trajectory_twc()
        assert s.tracking.local_mapping.worker_exc is None
        n_kf = int(s.tracking.map.kf_alive.sum())
        s.shutdown()
        return est, n_kf

    est_sync, kf_sync = one(False)
    est_thr, kf_thr = one(True)
    assert trajectory.ate_rmse(est_sync, gt) < 0.30
    assert trajectory.ate_rmse(est_thr, gt) < 0.30
    assert trajectory.ate_rmse(est_thr, est_sync) < 0.10
    assert kf_thr >= 2 and kf_sync >= 2


@pytest.mark.slow
def test_async_local_ba_tracks_like_sync():
    """tests/test_ba_variants.py::test_async_local_ba_tracks_like_sync."""
    _, frames, _ = synth_world.make_sequence(np.random.default_rng(7), n_frames=15, step=0.08)

    def one(asy):
        cfg = make_config()
        cfg.system.async_local_ba = asy
        s = run(cfg, frames, kf_every=3)
        assert s.failure_count == 0
        twc = np.stack(s.trajectory_twc())
        assert s.tracking.local_mapping._pending_ba is None
        s.shutdown()
        return twc, s.tracking.map

    twc_sync, m_sync = one(False)
    twc_async, m_async = one(True)
    assert m_sync.n_keyframes == m_async.n_keyframes
    d = np.linalg.norm(twc_sync[:, :3, 3] - twc_async[:, :3, 3], axis=1)
    assert d.max() < 5e-2, d.max()
    assert np.median(d) < 5e-3, np.median(d)
