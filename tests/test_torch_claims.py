"""The product's claims on the port's CPU path (tests/torch_claims.py).

The JAX package's four end-to-end checks, with their cases and gates, run
by the port with ``device="cpu"``; marked slow as the JAX tests are
(``python -m pytest -m slow tests/test_torch_claims.py -k seed5``). On the
card, ``chip_smoke.py``'s claims phase and ``claims_smoke.py`` run the same
functions.

Tier 1 holds the oracle's configuration against the JAX driver: seqA's
first 12 frames through ``examples/run_stereo.py`` (a JAX process on the
CPU without FMA contraction) and through the port's driver, with the
parity tool's flags (classic tracking, single-threaded, the vocabulary
attached), within test_torch_examples.py's tolerances: frames and failures
exact, ATE and every pose within 2e-3, keyframe stamps and the failure log
exact.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_claims as tc
from torch_parity import NO_FMA_FLAG, one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.usefixtures("one_thread")


def _assert_gates(res):
    assert not tc.failed(res), json.dumps(res["gates"], default=float)


@pytest.mark.slow
@pytest.mark.parametrize("case", list(tc.CASES))
def test_introspection_cycle_on_degraded_world(tmp_path, case):
    """test_introspection_helps.py: the band hurts vanilla tracking, the
    heatmaps localise it, the trained FCN flags it on unseen frames and
    introspection ON beats OFF on the same pixels."""
    _assert_gates(tc.iv_case(case, str(tmp_path), "cpu", log=lambda *_: None))


@pytest.mark.slow
def test_seqa_ate_within_reference_gate(tmp_path):
    """test_parity_ate.py: seqA within 5% of the reference C++ system's ATE."""
    tc.write_sequences(str(tmp_path), ["seqA"])
    tc.train_vocab(str(tmp_path), "cpu")
    _assert_gates(tc.oracle(str(tmp_path), "seqA", "cpu"))


@pytest.mark.slow
def test_full_introspection_cycle(tmp_path):
    """test_full_cycle.py: datagen, training, the trained FCN in the loop."""
    _assert_gates(tc.full_cycle(str(tmp_path), "cpu"))


@pytest.mark.slow
def test_kitti_geometry_everything_on(tmp_path):
    """test_kitti_e2e.py: run_stereo at KITTI-00 geometry with fused
    tracking, introspection, datagen and a vocabulary at once."""
    _assert_gates(tc.kitti_all_on(str(tmp_path), "cpu"))


N_ORACLE_FRAMES = 12


def test_oracle_configuration_matches_jax_driver(tmp_path):
    work = str(tmp_path)
    tc.write_sequences(work, ["seqA"], n_frames=N_ORACLE_FRAMES)
    voc = tc.train_vocab(work, "cpu")
    assert voc["images"] == N_ORACLE_FRAMES // 4 and voc["nodes"] > 1
    port = tc.oracle(work, "seqA", "cpu")
    out = tmp_path / "jax"
    argv = ["--dataset", "kitti", "--data_path", os.path.join(work, "seqA"),
            "--settings_path", os.path.join(work, "settings.yaml"),
            "--out_visualization_path", str(out), "--vocab_path", voc["path"]]
    env = dict(os.environ, JAX_PLATFORMS="cpu", IVT_FAST_COMPILE="1",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " " + NO_FMA_FLAG).strip())
    proc = subprocess.run([sys.executable, os.path.join(REPO, "examples", "run_stereo.py"),
                           *argv], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads((out / "stats.json").read_text())
    assert (port["frames"], port["failures"]) == (want["frames"], want["failures"])
    gt = np.load(os.path.join(work, "seqA", "gt_twc.npy"))
    jax_traj = np.loadtxt(out / "Trajectory_KITTI_000.txt")
    port_traj = np.loadtxt(os.path.join(port["out"], "Trajectory_KITTI_000.txt"))
    np.testing.assert_allclose(port_traj, jax_traj, rtol=0, atol=2e-3)
    from iv_slam_tpu_torch.io import trajectory

    est = trajectory.load_kitti(str(out / "Trajectory_KITTI_000.txt"))
    jax_ate = trajectory.ate_rmse(est, list(gt[-len(est):]))
    assert abs(port["ate_m"] - jax_ate) < 2e-3, (port["ate_m"], jax_ate)
    kf_got, kf_want = (np.loadtxt(os.path.join(d, "KeyFrameTrajectory_TUM_000.txt"), ndmin=2)
                       for d in (port["out"], str(out)))
    np.testing.assert_array_equal(kf_got[:, 0], kf_want[:, 0])
    np.testing.assert_allclose(kf_got[:, 1:], kf_want[:, 1:], rtol=0, atol=2e-3)
    with open(os.path.join(port["out"], "failure_log.txt"), "rb") as a, \
            open(out / "failure_log.txt", "rb") as b:
        assert a.read() == b.read()
