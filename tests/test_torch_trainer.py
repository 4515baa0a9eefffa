"""Port parity: the FCN trainer (iv_slam_tpu_torch.train.trainer) against
the JAX package's Trainer over 2 epochs of a synthetic dataset, on the CPU,
at 64x64 inputs and batch 2, and the port's checkpoint round trip.

Both trainers start from the same variables (JAX's init, carried across)
and see the same batches in the same order (the dataset shuffles with
np.random.default_rng(cfg.seed) in both). The learning rate is 2e-5, where
the two trajectories stay together over the 6 steps (tests/test_torch_train.py
explains why the recipe's 0.02 does not at a fresh init; at 2e-4 the second
epoch's loss parted by 0.5%): the per-epoch losses differed by at most
8.4e-5 relative and are held to 1e-3. JAX's snapshots (orbax) are not written: the port's
format is its own (torch.save), and its round trip is held bit for bit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv_slam_tpu.train import train_state as jts
from iv_slam_tpu.train import trainer as jtrainer
from iv_slam_tpu_torch.models import from_jax_variables
from iv_slam_tpu_torch.train import trainer as ttrainer
from torch_parity import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

HW = (64, 64)


class SynthDataset:
    """ImageQualityDataset's batches() over fixed arrays, shuffled with the
    caller's rng and dropping a last partial batch, as the real one."""

    def __init__(self, n=6, seed=0):
        rng = np.random.default_rng(seed)
        self.images = rng.normal(size=(n,) + HW + (3,)).astype(np.float32)
        self.targets = rng.uniform(size=(n, 8, 8, 1)).astype(np.float32)
        self.masks = (rng.uniform(size=(n, 8, 8, 1)) > 0.1).astype(np.float32)

    def __len__(self):
        return len(self.images)

    def batches(self, batch_size, rng, shuffle=True, prefetch=2):
        order = np.arange(len(self))
        if shuffle:
            rng.shuffle(order)
        for s in range(0, len(order) - batch_size + 1, batch_size):
            i = order[s:s + batch_size]
            yield dict(image=self.images[i], target=self.targets[i], mask=self.masks[i])


def jit_create_train_state(rng, net, input_hw=(512, 512), tx=None):
    """jts.create_train_state with the init under jit (the same values; the
    eager init of the flagship net takes ~30 s on this CPU)."""
    v = jax.jit(lambda r: net.init({"params": r, "dropout": jax.random.fold_in(r, 1)},
                                   jnp.zeros((1, 16, 16, 3), jnp.float32), train=True))(rng)
    return jts.TrainState(v["params"], v["batch_stats"], tx.init(v["params"]),
                          jnp.int32(0)), tx


def config(tmp_path, cls):
    return cls(num_epochs=2, batch_size=2, input_hw=HW, lr_encoder=2e-5, lr_decoder=2e-5,
               snapshot_interval=1, ckpt_dir=str(tmp_path / "ckpt"))


def test_trainer_history_matches_jax_and_checkpoints_round_trip(tmp_path, monkeypatch):
    monkeypatch.setattr(jts, "create_train_state", jit_create_train_state)
    monkeypatch.setattr(jtrainer.Trainer, "save", lambda self, path: None)
    ds, val = SynthDataset(6, 0), SynthDataset(4, 1)
    jt = jtrainer.Trainer(config(tmp_path, jtrainer.TrainConfig))
    tt = ttrainer.Trainer(config(tmp_path, ttrainer.TrainConfig), device="cpu")
    tt.net.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, jt.variables())))
    jh = jt.train(ds, val, log_fn=lambda *_: None)
    logs = []
    th = tt.train(ds, val, log_fn=logs.append)
    print(f"JAX {jh}\nport {th}")
    np.testing.assert_allclose(th.train_loss, jh.train_loss, rtol=1e-3)
    np.testing.assert_allclose(th.val_loss, jh.val_loss, rtol=1e-3)
    assert th.best_epoch == jh.best_epoch
    np.testing.assert_allclose(th.best_val, jh.best_val, rtol=1e-3)
    assert tt.state.step == int(jt.state.step) == 6 and len(logs) == 2

    ckpt = tmp_path / "ckpt"
    for name in ("best", "epoch_1", "epoch_2", "last"):
        assert (ckpt / name).is_file() and (ckpt / f"{name}.history.json").is_file(), name
    with open(ckpt / "last.history.json") as f:
        assert json.load(f)["train_loss"] == th.train_loss

    # restore into a fresh trainer: weights, statistics, step and history
    # come back bit for bit; the optimizer starts afresh (as the reference)
    t2 = ttrainer.Trainer(config(tmp_path, ttrainer.TrainConfig), device="cpu")
    t2.restore(os.path.join(ckpt, "last"))
    assert t2.state.step == tt.state.step
    a, b = tt.net.state_dict(), t2.net.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert t2.history == th
    assert not t2.state.optimizer.state
    assert t2.state.optimizer.param_groups[0]["lr"] == 2e-5
