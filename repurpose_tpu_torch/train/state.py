"""Train state and optimizer (``repurpose_tpu/train/state.py``).

``torch.optim.Adam(lr, weight_decay)`` applies L2 regularisation inside the
gradient (g + wd * p) before the moment updates: the reference's optimizer,
which the JAX package rebuilds with ``add_decayed_weights`` before
``scale_by_adam``. The learning rate is set before every update from the
schedule at the step count before the increment, as optax's ``count`` is.

With the regression loss off no loss reaches the reg head, so its gradients
stay ``None`` and Adam skips those parameters, weight decay included: the
freeze the JAX package builds with ``optax.masked``. Gradients are cleared
with ``zero_grad(set_to_none=True)`` and never zero-filled, so that holds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repurpose_tpu_torch.config import TrainConfig
from repurpose_tpu_torch.models.mmct import MMCT
from repurpose_tpu_torch.train.schedule import warmup_cosine_schedule


@dataclass
class TrainState:
    model: MMCT
    optimizer: torch.optim.Adam
    step: int = 0  # updates taken; the schedule reads it before each update
    nonfinite_count: torch.Tensor | None = None
    """int32 scalar on the model's device: steps whose loss or grad norm was
    non-finite. The step adds to it on the device, with no host sync; the
    Trainer reads it on its probe cadence and before every save."""

    def __post_init__(self) -> None:
        if self.nonfinite_count is None:
            device = next(self.model.parameters()).device
            self.nonfinite_count = torch.zeros((), dtype=torch.int32, device=device)


def make_optimizer(
    model: MMCT, train_cfg: TrainConfig, steps_per_epoch: int
) -> tuple[torch.optim.Adam, Callable[[int], float]]:
    """Adam (betas 0.9/0.999, eps 1e-8, L2 weight decay) over every
    parameter, and the warmup -> cosine schedule over the whole run."""
    total_steps = train_cfg.epochs * steps_per_epoch
    warmup_steps = train_cfg.warmup_epochs * steps_per_epoch
    schedule = warmup_cosine_schedule(train_cfg.lr, warmup_steps, total_steps)
    optimizer = torch.optim.Adam(
        model.parameters(), lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
        weight_decay=train_cfg.weight_decay,
    )
    return optimizer, schedule
