"""Port: BoW tracking, relocalization and localization-only mode
(slam/tracking.py, slam/system.py) against the JAX package's System, both
driven through ``torch_parity.bow_session`` over one synth_world sequence
(the JAX side in a process without FMA contraction): a vocabulary trained
by the port from the sequence's descriptors, use_bow and loop closing on,
fused tracking, a keyframe forced every third frame, localization-only
mode from frame 12 on. JAX's Sim3 and PnP hypothesis indices are
installed as the port's samplers.

* localization-only mode: from frame 12 on no keyframe is inserted and no
  map point survives; temporary VO points are created and deleted as in
  JAX (the same point counts), poses within 2e-3;
* _track_reference_keyframe_bow by a direct call (frame 9 again, from the
  last pose): the same success, the same associations, pose within 1e-4;
* _relocalization by a direct call (frame 5 again with the state set to
  LOST, which the reference's own loop never leaves standing): the same
  success and state, the same associations, pose within 1e-3: the pose LM
  starts from the PnP hypothesis, which the port's float64 EPnP and JAX's
  float32 one give ~1e-5 apart, and its 10 iterations leave the weakly
  constrained direction of tests/test_torch_system.py unsettled (1.05e-4
  seen).
"""

import numpy as np
import pytest

import synth_world
from iv_slam_tpu_torch.slam.system import System
from iv_slam_tpu_torch.slam.tracking import State
from test_torch_system import CAM, make_config, train_vocabulary
from torch_parity import (bow_session, jax_pnp_indices, jax_sim3_indices,  # noqa: F401
                          one_thread, run_reference, vocabulary_arrays)

pytestmark = pytest.mark.usefixtures("one_thread")

SESSION = dict(kf_every=3, loc_from=12, bow_frame=9, reloc_frame=5)


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    world, frames, gt = synth_world.make_sequence(np.random.default_rng(5), n_frames=16,
                                                  step=0.08)
    voc = train_vocabulary(frames)
    ref = run_reference("bow_system", tmp_path_factory.mktemp("bow_system"), timeout=900.0,
                        seed=5, n_frames=16, cam=np.array(CAM), n_features=800, n_levels=4,
                        **SESSION, **vocabulary_arrays(voc))
    cfg = make_config(fused=True)
    cfg.system.use_bow = cfg.system.enable_loop_closing = True
    s = System(cfg, 240, 320, device="cpu")
    s.attach_vocabulary(voc)
    s.tracking.loop_closing.sampler = jax_sim3_indices
    s.tracking.pnp_sampler = jax_pnp_indices
    got = bow_session(s, frames, **SESSION)
    return got, ref, s


def test_localization_mode_matches_jax(sessions):
    got, ref, s = sessions
    for k in ("failures", "n_keyframes", "n_points", "n_alive", "n_loops", "kfdb", "temporal",
              "loc_kfs", "loc_pts", "loc_alive"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # no keyframe and no surviving point from localization mode on
    assert got["n_keyframes"] == got["loc_kfs"] and got["n_alive"] == got["loc_alive"]
    assert got["n_points"] > got["loc_pts"]            # VO points were made, then deleted
    assert got["temporal"] == 0
    np.testing.assert_allclose(got["twc"][:, :3, 3], ref["twc"][:, :3, 3], rtol=0, atol=2e-3)
    np.testing.assert_allclose(got["twc"][:, :3, :3], ref["twc"][:, :3, :3], rtol=0, atol=2e-3)
    assert not s.tracking.only_tracking


@pytest.mark.parametrize("name", ["bow", "reloc"])
def test_direct_call_matches_jax(sessions, name):
    got, ref, s = sessions
    assert bool(got[f"{name}_ok"]) == bool(ref[f"{name}_ok"]) is True
    assert int(got[f"{name}_frame_id"]) == int(ref[f"{name}_frame_id"])
    np.testing.assert_array_equal(got[f"{name}_map_pt"], ref[f"{name}_map_pt"])
    assert (got[f"{name}_map_pt"] >= 0).sum() >= 50
    atol = 1e-4 if name == "bow" else 1e-3
    np.testing.assert_allclose(got[f"{name}_pose"], ref[f"{name}_pose"], rtol=0, atol=atol)
    if name == "reloc":
        assert int(got["reloc_state"]) == int(ref["reloc_state"]) == State.OK.value
