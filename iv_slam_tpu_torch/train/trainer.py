"""FCN training loop (training/train_modular.py re-designed).

Port of ``iv_slam_tpu/train/trainer.py``: an epoch loop with validation
after each epoch, snapshots every ``snapshot_interval`` epochs, the best
epoch by validation loss and the last one (the reference's
snapshot/besterror logic, train_modular.py:74-110, 398-416, 459-472), and
resume. Batches come in ``np.random.default_rng(cfg.seed)``'s order, as in
the JAX package, so both see the same batches.

Two behaviours of the reference are kept on purpose:
  * the poly schedule's horizon is ``num_epochs * 1000`` steps, never
    refined from the dataset's size;
  * ``restore`` brings back the weights, the BatchNorm statistics and the
    step, not the optimizer: momentum and the schedule's count start
    afresh (the JAX trainer keeps its fresh optax state).

A snapshot is ``torch.save`` of the model's state dict and the step at
<path>, and the history at <path>.history.json.

With a ``parallel.mesh.DataParallel`` each rank trains its rows of every
batch (``train_state.train_step``), validates the whole batch, and rank 0
writes the snapshots.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.introspection import IntrospectionNet
from ..models.layers import set_process_group
from . import train_state as ts


@dataclass
class TrainConfig:
    num_epochs: int = 20
    batch_size: int = 8
    lr_encoder: float = 0.02
    lr_decoder: float = 0.02
    momentum: float = 0.9
    weight_decay: float = 1e-4
    lr_pow: float = 0.9
    deep_sup_scale: float = 0.4
    snapshot_interval: int = 5
    input_hw: tuple = (512, 512)
    seed: int = 0
    ckpt_dir: str = "checkpoints"
    # model selection (MODEL.arch_encoder/arch_decoder/fc_dim in the yacs
    # tree, config/defaults.py): any pair from models/zoo.py
    arch_encoder: str = "mobilenetv2dilated"
    arch_decoder: str = "c1_deepsup"
    fc_dim: int = 0          # 0 = infer from the encoder arch
    num_class: int = 1
    regression_mode: bool = True


@dataclass
class History:
    train_loss: list = field(default_factory=list)
    val_loss: list = field(default_factory=list)
    best_val: float = float("inf")
    best_epoch: int = -1


def build_net(cfg: TrainConfig) -> torch.nn.Module:
    """The flagship IntrospectionNet for MobileNetV2-dilated + C1-DeepSup
    with one class, else the zoo's SegmentationModel."""
    if (cfg.arch_encoder, cfg.arch_decoder) == ("mobilenetv2dilated", "c1_deepsup") \
            and cfg.num_class == 1:
        return IntrospectionNet()
    from ..models.zoo import SegmentationModel

    return SegmentationModel(cfg.arch_encoder, cfg.arch_decoder, cfg.fc_dim, cfg.num_class,
                             cfg.regression_mode)


def load_snapshot(net: torch.nn.Module, path: str, device) -> int:
    """The weights and BatchNorm statistics of the snapshot at `path` into
    `net` (on `device`); returns the snapshot's step."""
    snap = torch.load(path, map_location=device)
    net.load_state_dict(snap["model"])
    return int(snap["step"])


def _mean(losses) -> float:
    """The float64 mean of 0-d loss tensors (one download), NaN for none."""
    if not losses:
        return float("nan")
    return float(np.mean(torch.stack(losses).double().cpu().numpy()))


class Trainer:
    def __init__(self, cfg: TrainConfig, device=None, dp=None):
        """`device`: the card unless the CPU is named. `dp`: this rank's
        ``parallel.mesh.DataParallel``, or None for one process."""
        self.cfg = cfg
        self.dp = dp
        self.net = build_net(cfg)
        self.state = ts.create_train_state(
            self.net, cfg.seed, device, lr_encoder=cfg.lr_encoder, lr_decoder=cfg.lr_decoder,
            max_iters=cfg.num_epochs * 1000, momentum=cfg.momentum,
            weight_decay=cfg.weight_decay, lr_pow=cfg.lr_pow)
        self.device = next(self.net.parameters()).device
        if dp is not None:
            set_process_group(self.net, torch.distributed.group.WORLD)
        self.history = History()

    def step(self, batch) -> dict:
        """One train step on a batch of the dataset."""
        return ts.train_step(self.state, batch, self.dp, self.cfg.deep_sup_scale)

    def train(self, train_ds, val_ds=None, log_fn=print) -> History:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed)
        for epoch in range(cfg.num_epochs):
            losses = [self.step(b)["loss"] for b in train_ds.batches(cfg.batch_size, rng)]
            train_loss = _mean(losses)
            self.history.train_loss.append(train_loss)

            val_loss = float("nan")
            if val_ds is not None and len(val_ds) > 0:
                vlosses = [ts.eval_loss(self.net, b)
                           for b in val_ds.batches(cfg.batch_size, rng, shuffle=False)]
                val_loss = _mean(vlosses)
            self.history.val_loss.append(val_loss)
            log_fn(f"epoch {epoch}: train {train_loss:.4f} val {val_loss:.4f}")

            if val_ds is not None and val_loss < self.history.best_val:
                self.history.best_val = val_loss
                self.history.best_epoch = epoch
                self.save(os.path.join(cfg.ckpt_dir, "best"))
            if (epoch + 1) % cfg.snapshot_interval == 0:
                self.save(os.path.join(cfg.ckpt_dir, f"epoch_{epoch + 1}"))
        self.save(os.path.join(cfg.ckpt_dir, "last"))
        return self.history

    # --- checkpointing ----------------------------------------------------

    def save(self, path: str) -> None:
        """The weights, BatchNorm statistics and step at `path`, the history
        beside it (rank 0 only)."""
        if self.dp is not None and self.dp.rank != 0:
            return
        path = os.path.abspath(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save({"model": self.net.state_dict(), "step": self.state.step}, path)
        with open(path + ".history.json", "w") as f:
            json.dump(dict(train_loss=self.history.train_loss, val_loss=self.history.val_loss,
                           best_val=self.history.best_val, best_epoch=self.history.best_epoch),
                      f)

    def restore(self, path: str) -> None:
        """Weights, BatchNorm statistics and step from `path` (not the
        optimizer's state, as the reference), and the history when it is
        there."""
        path = os.path.abspath(path)
        self.state.step = load_snapshot(self.net, path, self.device)
        hist = path + ".history.json"
        if os.path.exists(hist):
            with open(hist) as f:
                h = json.load(f)
            self.history = History(h["train_loss"], h["val_loss"], h["best_val"],
                                   h["best_epoch"])

