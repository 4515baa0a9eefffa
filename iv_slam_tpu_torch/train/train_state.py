"""Optimizer and train step for the introspection FCN.

Port of ``iv_slam_tpu/train/train_state.py``, the reference recipe
(training/train_modular.py):
  * two SGD groups (encoder / decoder) with their own base learning rates
    (TRAIN.lr_encoder = TRAIN.lr_decoder = 0.02), momentum 0.9;
  * poly decay: lr = base (1 - clip(step / max_iters))^0.9, step 0 at the
    base rate (optax's count);
  * weight decay 1e-4 on tensors of rank >= 2 only: BatchNorm scales and
    every bias are left alone (group_weight, train_modular.py:35-71);
  * masked MSE + 0.4x deep supervision (losses.py).

optax's chain (add_decayed_weights, then sgd's trace and scale) is
``torch.optim.SGD`` with dampening 0 and no Nesterov: both add wd * p to the
gradient, keep buf = g + 0.9 buf (buf = g at the first step) and step by
-lr * buf. So the optimizer is four SGD param groups (encoder and decoder,
each with and without decay) under one poly ``LambdaLR``.

``train_step`` runs eagerly; it is the counterpart of the JAX package's
jitted (``make_jit_train_step``) step. Given a ``parallel.mesh.DataParallel``
it trains this rank's share of the batch and all-reduces the gradients.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch
from torch import nn

from ..models.layers import flax_init_
from ..slam import resolve_device
from ..utils.profiling import span
from .losses import DEEP_SUP_SCALE, deep_sup_loss, masked_mse


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.SGD
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0


def poly_factor(max_iters: int, power: float = 0.9):
    """count -> (1 - clip(count / max_iters, 0, 1))^power."""
    def fn(count):
        frac = min(max(count / max_iters, 0.0), 1.0)
        return (1.0 - frac) ** power

    return fn


def poly_schedule(base_lr: float, max_iters: int, power: float = 0.9):
    """count -> the learning rate at that step."""
    factor = poly_factor(max_iters, power)
    return lambda count: base_lr * factor(count)


def wd_mask(p: torch.Tensor) -> bool:
    """Weight decay only on rank >= 2 kernels (group_weight semantics)."""
    return p.ndim >= 2


def param_groups(model: nn.Module, lr_encoder: float, lr_decoder: float,
                 weight_decay: float) -> List[dict]:
    """SGD param groups: parameters under a module named "encoder" go with
    lr_encoder, the rest with lr_decoder; each split into the tensors that
    decay and those that do not."""
    split = {(part, decay): [] for part in ("encoder", "decoder") for decay in (True, False)}
    for name, p in model.named_parameters():
        part = "encoder" if "encoder" in name.split(".") else "decoder"
        split[(part, wd_mask(p))].append(p)
    lrs = {"encoder": lr_encoder, "decoder": lr_decoder}
    return [dict(params=ps, lr=lrs[part], weight_decay=weight_decay if decay else 0.0,
                 name=part + ("" if decay else "_no_decay"))
            for (part, decay), ps in split.items()]


def make_optimizer(model: nn.Module, lr_encoder: float = 0.02, lr_decoder: float = 0.02,
                   max_iters: int = 100_000, momentum: float = 0.9,
                   weight_decay: float = 1e-4, lr_pow: float = 0.9):
    """(SGD, its poly LambdaLR): call ``scheduler.step()`` after each
    ``optimizer.step()``."""
    opt = torch.optim.SGD(param_groups(model, lr_encoder, lr_decoder, weight_decay),
                          lr=lr_encoder, momentum=momentum, dampening=0.0, nesterov=False)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, poly_factor(max_iters, lr_pow))
    return opt, sched


def create_train_state(net: nn.Module, seed: int = 0, device=None, **opt_kw) -> TrainState:
    """`net` with flax's default initialisation drawn from
    ``torch.Generator(seed)``, on `device` (the card unless the CPU is
    named), and its optimizer (``make_optimizer``'s keywords)."""
    device = resolve_device(device, "create_train_state")
    flax_init_(net, torch.Generator().manual_seed(seed))
    net.to(device)
    opt, sched = make_optimizer(net, **opt_kw)
    return TrainState(net, opt, sched)


def batch_tensors(batch: Dict[str, np.ndarray], device: torch.device, rows=slice(None)):
    """A batch of the dataset (image (B, H, W, 3), target and mask
    (B, h, w, 1), NHWC numpy) -> NCHW tensors on `device`, rows `rows`."""
    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(a[rows])).to(device).permute(0, 3, 1, 2)

    return nchw(batch["image"]), nchw(batch["target"]), nchw(batch["mask"])


def train_step(state: TrainState, batch: Dict[str, np.ndarray], dp=None,
               deep_sup_scale: float = DEEP_SUP_SCALE) -> Dict[str, torch.Tensor]:
    """One SGD step on `batch` (image normalized, target and mask at 1/8 of
    the input). Returns the loss and the main head's MSE of the whole batch
    as 0-d tensors on the model's device (reading them syncs).

    With `dp` (``parallel.mesh.DataParallel``) this rank trains its rows of
    the batch: each rank's squared error is divided by the mask total of
    the whole batch, so the ranks' losses add up to the whole batch's and
    the summed gradients are its gradient; the BatchNorms average their
    statistics over the ranks when ``models.set_process_group`` gave them
    the group; the gradients' and the metrics' all-reduce is the span
    ``train.allreduce``. Its spans carry ``step=``, the state's step count."""
    with span("train.step", step=state.step):
        return _train_step(state, batch, dp, deep_sup_scale)


def _train_step(state, batch, dp, deep_sup_scale):
    model = state.model
    device = next(model.parameters()).device
    step = state.step
    model.train()
    rows = slice(None) if dp is None else dp.rows(len(batch["image"]))
    with span("train.upload", step=step):
        image, target, mask = batch_tensors(batch, device, rows)
        mask_sum = None
        if dp is not None:
            mask_sum = torch.tensor(float(np.asarray(batch["mask"], np.float64).sum()),
                                    dtype=torch.float32, device=device)
    with span("train.forward", step=step):
        out = model(image)
        if isinstance(out, tuple):
            # deep-supervision decoders return (pred, pred_deepsup)
            loss, main = deep_sup_loss(out[0], out[1], target, mask, deep_sup_scale, mask_sum)
        else:
            loss = main = masked_mse(out, target, mask, mask_sum)
    with span("train.backward", step=step):
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        metrics = torch.stack([loss.detach(), main.detach()])
        if dp is not None:
            from ..parallel.mesh import all_reduce_grads, all_reduce_sum

            with span("train.allreduce", step=step):
                all_reduce_grads(model, dp)
                metrics = all_reduce_sum(metrics, dp)
    with span("train.optimizer", step=step):
        state.optimizer.step()
        state.scheduler.step()
    state.step += 1
    return {"loss": metrics[0], "mse": metrics[1]}


@torch.no_grad()
def eval_loss(model: nn.Module, batch: Dict[str, np.ndarray]) -> torch.Tensor:
    """The masked MSE of the eval-mode prediction on `batch` (0-d tensor)."""
    device = next(model.parameters()).device
    model.eval()
    image, target, mask = batch_tensors(batch, device)
    return masked_mse(model(image), target, mask)

