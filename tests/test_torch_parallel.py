"""The port's multi-process paths (iv_slam_tpu_torch.parallel) on the CPU:
two gloo ranks (torch.multiprocessing, spawned) against one process.

* The data-parallel train step: each rank trains its half of a batch of 4
  (32x32, the flagship net); the BatchNorms average their statistics over
  the ranks and the gradients are summed, so the step equals the
  one-process step on the whole batch up to float32 rounding of the other
  summation order (measured: the loss 2.3e-6 relative, held at 1e-5; the
  running statistics 3.0e-6, held at 1e-5; the parameters after a step at
  lr 0.02 5.4e-4, held at 2e-3: at a fresh init the flagship's gradient
  amplifies float32 rounding, and JAX's own jitted and op-by-op steps
  differ by 5.0e-4, tests/test_torch_train.py).
* ShardedReplay on one rank and on two equals StereoFrontend.process on
  every frame, bit for bit, and its BoW leaf ids equal the host descent.

The JAX package's ShardedDatagen is held in test_torch_sharded_datagen.py.
"""

import numpy as np
import pytest
import torch

import torch_dp_worker as w
from iv_slam_tpu_torch.parallel import mesh
from iv_slam_tpu_torch.parallel.replay import ShardedReplay
from torch_parity import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dp") / "rank0.npz")
    mesh.spawn(w.rank_main, 2, out)
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def test_split_batch_step_equals_whole_batch_step(two_ranks):
    loss, mse, sd = w.trained_state(None)
    np.testing.assert_allclose([float(two_ranks["loss"]), float(two_ranks["mse"])], [loss, mse],
                               rtol=1e-5)
    d_p = d_s = 0.0
    for k, v in sd.items():
        got = two_ranks[f"sd/{k}"]
        if k.endswith("num_batches_tracked"):
            assert got == v == 1
        elif k.endswith(("running_mean", "running_var")):
            d_s = max(d_s, float(np.abs(got - v).max()))
        else:
            d_p = max(d_p, float(np.abs(got - v).max()))
    print(f"two ranks against one: params {d_p:.3g}, running statistics {d_s:.3g}")
    assert d_p <= 2e-3 and d_s <= 1e-5


def test_batch_rows_split():
    dps = [mesh.DataParallel(r, 4) for r in range(4)]
    assert [d.rows(8) for d in dps] == [slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    assert [list(d.items(5)) for d in dps] == [[0, 1], [2, 3], [4], []]
    with pytest.raises(ValueError):
        dps[0].rows(6)


FIELDS = ("xy", "octave", "valid", "desc", "angle", "u_right", "depth", "qual")


@pytest.fixture(scope="module")
def per_frame():
    cfg, lefts, rights = w.replay_inputs()
    rep = ShardedReplay(cfg, 240, 320, vocabulary=w.vocabulary(), device="cpu")
    frames = [rep.frontend.process(lefts[i], rights[i], 0.0) for i in range(len(lefts))]
    return rep, lefts, rights, frames


def check_frame(rec, fr, voc):
    want = dict(xy=fr.xy, octave=fr.octave, valid=fr.valid, desc=fr.desc, angle=fr.angle,
                u_right=fr.u_right, depth=fr.depth, qual=fr.qual_score)
    for f in FIELDS:
        np.testing.assert_array_equal(rec[f], want[f], err_msg=f)
    v = rec["valid"]
    np.testing.assert_array_equal(rec["bow_nodes"][v], voc.transform_words(rec["desc"][v]))
    assert (rec["bow_nodes"][~v] == -1).all() and v.sum() > 100


def test_replay_one_rank_equals_frontend(per_frame):
    rep, lefts, rights, frames = per_frame
    recs = rep.process_batch(lefts, rights)
    assert len(recs) == len(frames)
    for rec, fr in zip(recs, frames):
        check_frame(rec, fr, rep.vocabulary)


def test_replay_two_ranks_equals_frontend(per_frame, two_ranks):
    rep, _, _, frames = per_frame
    assert int(two_ranks["n_recs"]) == len(frames)
    for i, fr in enumerate(frames):
        rec = {k.split("/", 1)[1]: v for k, v in two_ranks.items() if k.startswith(f"rec{i}/")}
        check_frame(rec, fr, rep.vocabulary)


def test_gloo_backend_for_ranks_sharing_a_device():
    assert mesh.backend_for(torch.device("cpu"), 2) == "gloo"
