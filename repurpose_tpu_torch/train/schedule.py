"""Learning-rate schedule: linear warmup then cosine annealing
(``repurpose_tpu/train/schedule.py``).

With the shipped config (warmup 0) this is ``lr * 0.5 * (1 + cos(pi * step /
total_steps))``, the reference's per-iteration CosineAnnealingLR. With warmup
the cosine phase starts counting at the end of warmup. Past ``total_steps``
the rate holds at the annealed floor instead of rising again.
"""

from __future__ import annotations

import math
from typing import Callable


def warmup_cosine_schedule(
    base_lr: float, warmup_steps: int, total_steps: int
) -> Callable[[int], float]:
    """``schedule(step) -> lr`` for a step count (0 at the first update)."""
    total_steps = max(total_steps, 1)

    def schedule(step: int) -> float:
        step = float(step)
        if warmup_steps > 0 and step < warmup_steps:
            return base_lr * (step + 1.0) / warmup_steps
        cos_step = min(max(step - warmup_steps, 0.0), float(total_steps))
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * cos_step / total_steps))

    return schedule
