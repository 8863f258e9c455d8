"""LR schedules for SSL pretraining, as functions of the step (the port of ``lr_schedulers.py``).

Each factory returns ``schedule(step) -> lr``, the learning rate of the update
numbered ``step`` from 0: a train step sets it on its optimizer before each
update, or ``torch.optim.lr_scheduler.LambdaLR(opt, lambda s: schedule(s) / base_lr)``
takes it.
"""

from __future__ import annotations

import math
from typing import Callable

__all__ = ["linear_decay_schedule", "tri_stage_schedule"]


def linear_decay_schedule(base_lr: float, warmup_updates: int, max_updates: int) -> Callable[[int], float]:
    """Linear warm-up to ``base_lr`` at ``warmup_updates``, then linear decay to 0 at ``max_updates``."""

    def schedule(step: int) -> float:
        if step <= warmup_updates:
            scale = step / max(warmup_updates, 1)
        else:
            scale = (max_updates - step) / max(max_updates - warmup_updates, 1)
        return base_lr * min(max(scale, 0.0), 1.0)

    return schedule


def tri_stage_schedule(base_lr: float, warmup: int, hold: int, decay: int, init_scale: float = 0.01,
                       final_scale: float = 0.05) -> Callable[[int], float]:
    """fairseq's tri-stage schedule: linear warm-up from ``init_scale``, a hold at ``base_lr``, then
    exponential decay to ``final_scale`` over ``decay`` steps."""

    def schedule(step: int) -> float:
        if step < warmup:
            return base_lr * (init_scale + (1 - init_scale) * step / max(warmup, 1))
        if step < warmup + hold:
            return base_lr
        decay_pct = min(max((step - warmup - hold) / max(decay, 1), 0.0), 1.0)
        return base_lr * math.exp(math.log(final_scale) * decay_pct)

    return schedule
