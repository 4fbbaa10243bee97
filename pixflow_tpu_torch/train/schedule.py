"""Per-step learning-rate schedules: the port of
`pixflow_tpu/train/schedule.py` (reference `contrast/lr_scheduler.py`,
stepped every iteration). Schedules map a step to a Python float, evaluated
in float32 like the JAX package:

    t <= warmup:  base/mult * ((mult-1) * t/warmup + 1)
    cosine:       eta_min + (base-eta_min) * (1 + cos(pi*(t-warmup)/T_max)) / 2
    multi-step:   base * gamma^(#milestones <= t-warmup)
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np

ETA_MIN = 1e-6
_f32 = np.float32


def scale_lr(base_lr: float, global_batch_size: int) -> float:
    """Linear LR scaling: lr = global_batch / 256 * base_lr."""
    return global_batch_size / 256.0 * base_lr


def _warm(base_lr, warmup_multiplier, warmup_steps, t):
    if warmup_steps > 0:
        return _f32(base_lr / warmup_multiplier) * (
            _f32(warmup_multiplier - 1.0) * t / _f32(warmup_steps) + _f32(1.0))
    return _f32(base_lr)


def warmup_cosine(base_lr: float, epochs: int, warmup_epoch: int,
                  steps_per_epoch: int, warmup_multiplier: float = 100.0
                  ) -> Callable[[int], float]:
    warmup_steps = warmup_epoch * steps_per_epoch
    t_max = max((epochs - warmup_epoch) * steps_per_epoch, 1)

    def schedule(step: int) -> float:
        t = _f32(step)
        if t <= warmup_steps:
            return float(_warm(base_lr, warmup_multiplier, warmup_steps, t))
        cos = np.cos(_f32(math.pi) * (t - _f32(warmup_steps)) / _f32(t_max))
        return float(_f32(ETA_MIN) + _f32(base_lr - ETA_MIN)
                     * (_f32(1.0) + cos) / _f32(2.0))

    return schedule


def warmup_multistep(base_lr: float, warmup_epoch: int, steps_per_epoch: int,
                     decay_epochs: Sequence[int], decay_rate: float = 0.1,
                     warmup_multiplier: float = 100.0) -> Callable[[int], float]:
    warmup_steps = warmup_epoch * steps_per_epoch
    milestones = [(m - warmup_epoch) * steps_per_epoch for m in decay_epochs]

    def schedule(step: int) -> float:
        t = _f32(step)
        if t <= warmup_steps:
            return float(_warm(base_lr, warmup_multiplier, warmup_steps, t))
        n_decays = sum(int(t - warmup_steps >= m) for m in milestones)
        return float(_f32(base_lr) * _f32(decay_rate) ** n_decays)

    return schedule


def make_lr_schedule(lr_scheduler: str, base_lr: float, epochs: int,
                     warmup_epoch: int, steps_per_epoch: int,
                     warmup_multiplier: float = 100.0,
                     decay_epochs: Sequence[int] = (120, 160, 200),
                     decay_rate: float = 0.1) -> Callable[[int], float]:
    """Factory mirroring the reference's `get_scheduler`."""
    if "cosine" in lr_scheduler:
        return warmup_cosine(base_lr, epochs, warmup_epoch, steps_per_epoch,
                             warmup_multiplier)
    if "step" in lr_scheduler:
        return warmup_multistep(base_lr, warmup_epoch, steps_per_epoch,
                                decay_epochs, decay_rate, warmup_multiplier)
    raise NotImplementedError(f"scheduler '{lr_scheduler}' not supported")
