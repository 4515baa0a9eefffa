"""Port: chained (pipelined) fused tracking (slam/tracking.py,
FusedTracker.track_chained), tests/test_chained_tracking.py's checks on the
port, and the port's chained System against the JAX package's.

* depth 1 and depth 2 against the unchained fused run over the reference
  test's 14 frames: every frame in the trajectory, |dATE| < 0.02 m, ATE <
  0.2 m, keyframes within 1 (the reference's gates), speculations consumed;
* a trajectory read in mid-sequence flushes the pipeline;
* the port's chained System (depth 2) against the JAX package's chained
  System on the same frames, a keyframe forced on the processed frame
  after every third call (as tests/test_torch_system.py forces them: this
  world makes none of its own in 14 frames), so that keyframe events void
  queued speculations and the queue is re-speculated; the JAX side in a
  process without FMA contraction (tests/torch_parity.py explains why):
  the same keyframe stamps and map size, every pose within 2e-3;
* a worker event (its "map changed" signal) forced between every dispatch
  and its consumption: no speculation is used (the version stamp voids
  each), and the run equals the unchained run bit for bit: the fresh
  dispatch is the unchained step.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import synth_world
from iv_slam_tpu_torch import config as tconfig
from iv_slam_tpu_torch.io import trajectory
from iv_slam_tpu_torch.slam.system import System
from iv_slam_tpu_torch.slam.tracking import State
from torch_parity import NO_FMA_FLAG, one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

H, W = 240, 320
N_FRAMES = 14
HERE = os.path.dirname(os.path.abspath(__file__))
KF_EVERY = 3


def make_config(chained: bool, depth: int = 1, pkg=tconfig):
    cfg = pkg.Config()
    cfg.camera = pkg.CameraConfig(fx=400.0, fy=400.0, cx=160.0, cy=120.0, bf=200.0,
                                  width=W, height=H, th_depth=35.0, fps=10.0)
    cfg.orb = pkg.ORBConfig(n_features=600, n_levels=4)
    cfg.system.fused_tracking = True
    cfg.system.chained_tracking = chained
    cfg.system.chain_depth = depth
    return cfg


def force_keyframes(s, i, kf_every):
    """A keyframe on the frame tracking just finished, after every
    kf_every-th call (either package's System)."""
    tr = s.tracking
    if i % kf_every == kf_every - 1 and tr.current.frame_id != tr.last_kf_frame_id:
        tr._create_new_keyframe()


def run(cfg, frames, gt, after_frame=None, kf_every=0):
    """Track the frames; returns the trajectory, ATE, live keyframes, each
    processed frame's speculation used or not, keyframe stamps, failures
    and map points."""
    s = System(cfg, H, W, device="cpu")
    tr = s.tracking
    used = []
    head = tr._process_chain_head

    def counted():
        pose = head()
        used.append(tr._used_spec)
        return pose

    tr._process_chain_head = counted
    for i, (left, right) in enumerate(frames):
        s.track_stereo(left, right, timestamp=i * 0.1)
        if kf_every:
            force_keyframes(s, i, kf_every)
        if after_frame is not None:
            after_frame(s)
    est = s.trajectory_twc()
    assert s.state == State.OK
    m = tr.map
    out = dict(est=np.stack(est), ate=float(trajectory.ate_rmse(est, gt[-len(est):])),
               kfs=int(m.kf_alive[:m.n_keyframes].sum()), used=used,
               stamps=np.array(m.kf_timestamp[:m.n_keyframes]), failures=s.failure_count,
               n_points=m.n_points)
    s.shutdown()
    return out


@pytest.fixture(scope="module")
def seq():
    world, frames, gt = synth_world.make_sequence(np.random.default_rng(42),
                                                  n_frames=N_FRAMES, step=0.08)
    return frames, gt


@pytest.fixture(scope="module")
def unchained(seq):
    return run(make_config(False), *seq)


@pytest.mark.parametrize("depth", [1, 2])
def test_chained_matches_unchained(seq, unchained, depth):
    c = run(make_config(True, depth), *seq)
    assert len(c["est"]) == len(unchained["est"]) == N_FRAMES
    assert abs(c["ate"] - unchained["ate"]) < 0.02, (c["ate"], unchained["ate"])
    assert c["ate"] < 0.2
    assert abs(c["kfs"] - unchained["kfs"]) <= 1
    # frames after the first two go through the pipeline, and most
    # speculations are consumed
    assert len(c["used"]) == N_FRAMES - 2
    assert sum(c["used"]) >= len(c["used"]) // 2, c["used"]


def test_chained_mid_sequence_flush(rng):
    world, frames, gt = synth_world.make_sequence(rng, n_frames=10, step=0.08)
    s = System(make_config(True), H, W, device="cpu")
    for i, (left, right) in enumerate(frames[:6]):
        s.track_stereo(left, right, timestamp=i * 0.1)
    assert len(s.tracking._pendq) == 1
    # a mid-run trajectory read flushes the frame in flight
    assert len(s.trajectory_twc()) == 6
    assert not s.tracking._pendq
    for i, (left, right) in enumerate(frames[6:], start=6):
        s.track_stereo(left, right, timestamp=i * 0.1)
    assert len(s.trajectory_twc()) == 10
    assert s.state == State.OK
    s.shutdown()


def test_voided_speculation_is_the_unchained_step(seq, unchained):
    def worker_event(s):
        # the worker signals a finished event, and tracking polls it (the
        # next call would, or the final flush would come first)
        s.tracking.local_mapping._map_changed = True
        s.tracking._poll_async_merges()

    c = run(make_config(True), *seq, after_frame=worker_event)
    assert len(c["used"]) == N_FRAMES - 2 and not any(c["used"])
    np.testing.assert_array_equal(c["est"], unchained["est"])
    np.testing.assert_array_equal(c["stamps"], unchained["stamps"])


def test_chain_inverse_matches_jax():
    """The pose chain's 4x4 inverse (numerics.inverse, LU as
    jnp.linalg.inv) on rigid poses and on general matrices."""
    import jax.numpy as jnp
    import torch

    from iv_slam_tpu_torch import numerics
    from iv_slam_tpu_torch.geometry import se3

    rng = np.random.default_rng(11)
    xi = torch.tensor(rng.normal(0, [0.3, 0.3, 0.3, 2, 2, 2], (64, 6)).astype(np.float32))
    poses = se3.se3_exp(xi)
    general = torch.tensor(rng.normal(0, 1, (64, 4, 4)).astype(np.float32)) + 4 * torch.eye(4)
    # a few ulps apart: LAPACK's kernels contract multiply-adds
    for m, rtol in ((poses, 0.0), (general, 5e-6)):
        got = numerics.inverse(m).numpy()
        np.testing.assert_allclose(got, np.asarray(jnp.linalg.inv(m.numpy())), rtol=rtol,
                                   atol=2e-6)
        np.testing.assert_allclose(got @ m.numpy(), np.broadcast_to(np.eye(4), got.shape),
                                   rtol=0, atol=1e-5)


# ---- the JAX package's chained System, in a process without FMA ----------

def _task_chained(n_frames, depth, kf_every):
    from iv_slam_tpu import config as jconfig
    from iv_slam_tpu.slam.system import System as JSystem

    world, frames, gt = synth_world.make_sequence(np.random.default_rng(42),
                                                  n_frames=int(n_frames), step=0.08)
    s = JSystem(make_config(True, int(depth), jconfig), H, W)
    for i, (left, right) in enumerate(frames):
        s.track_stereo(left, right, timestamp=i * 0.1)
        force_keyframes(s, i, int(kf_every))
    m = s.tracking.map
    out = dict(twc=np.stack(s.trajectory_twc()), failures=np.int64(s.failure_count),
               kf_timestamp=np.array(m.kf_timestamp[:m.n_keyframes]),
               n_points=np.int64(m.n_points))
    s.shutdown()
    return out


def _jax(tmp_path, **inputs) -> dict:
    src, dst = str(tmp_path / "in.npz"), str(tmp_path / "out.npz")
    np.savez(src, **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " " + NO_FMA_FLAG).strip())
    env["PYTHONPATH"] = os.pathsep.join([os.path.dirname(HERE), env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), src, dst], env=env,
                          cwd=os.path.dirname(HERE), capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(dst) as z:
        return {k: z[k] for k in z.files}


def test_chained_system_matches_jax(seq, tmp_path):
    ref = _jax(tmp_path, n_frames=N_FRAMES, depth=2, kf_every=KF_EVERY)
    c = run(make_config(True, 2), *seq, kf_every=KF_EVERY)
    assert c["failures"] == 0 == int(ref["failures"])
    np.testing.assert_array_equal(c["stamps"], ref["kf_timestamp"])
    assert len(c["stamps"]) >= 4 and c["n_points"] == int(ref["n_points"])
    assert not all(c["used"])          # keyframe events voided speculations
    np.testing.assert_allclose(c["est"][:, :3, 3], ref["twc"][:, :3, 3], rtol=0, atol=2e-3)
    np.testing.assert_allclose(c["est"][:, :3, :3], ref["twc"][:, :3, :3], rtol=0, atol=2e-3)


if __name__ == "__main__":
    sys.path[:0] = [HERE, os.path.dirname(HERE)]
    import conftest  # noqa: F401  (the tests' JAX-on-CPU settings)

    with np.load(sys.argv[1]) as z:
        kwargs = {k: z[k] for k in z.files}
    np.savez(sys.argv[2], **_task_chained(**kwargs))
