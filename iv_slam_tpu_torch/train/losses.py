"""Training losses for the introspection FCN.

Port of ``iv_slam_tpu/train/losses.py``. MaskedMSELoss
(lib/utils/utils.py:10-18): sum((pred - target)^2 * mask) / sum(mask); the
deep-supervision composition loss = main + 0.4 aux
(networks/models/models.py:47-54, TRAIN.deep_sup_scale).

``mask_sum`` lets a data-parallel rank divide its share of the squared
error by the mask total of the whole batch, so that the ranks' losses add
up to the loss of the whole batch (``train_state.train_step``).
"""

from __future__ import annotations

from typing import Optional

import torch

DEEP_SUP_SCALE = 0.4


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
               mask_sum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """pred/target/mask of one shape, or broadcastable."""
    se = (pred - target) ** 2 * mask
    if mask_sum is None:
        mask_sum = mask.sum()
    return se.sum() / torch.clamp(mask_sum, min=1.0)


def deep_sup_loss(pred: torch.Tensor, pred_deepsup: torch.Tensor, target: torch.Tensor,
                  mask: torch.Tensor, deep_sup_scale: float = DEEP_SUP_SCALE,
                  mask_sum: Optional[torch.Tensor] = None):
    """(main + deep_sup_scale * aux, main)."""
    main = masked_mse(pred, target, mask, mask_sum)
    aux = masked_mse(pred_deepsup, target, mask, mask_sum)
    return main + deep_sup_scale * aux, main
