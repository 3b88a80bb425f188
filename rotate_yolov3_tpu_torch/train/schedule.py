"""Darknet-style LR schedule: burn-in warmup + step decays.

Counterpart of ``rotate_yolov3_tpu/train/schedule.py``: each schedule is a
plain function of the optimizer step count (0 before the first update)
that returns the learning rate as a Python float, computed in float32 as
the reference computes it.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def darknet_schedule(base_lr: float, burn_in: int = 1000,
                     steps: Sequence[float] = (400000, 450000),
                     scales: Sequence[float] = (0.1, 0.1),
                     power: float = 4.0):
    """lr(step) = base * ((step+1)/burn_in)^power during burn-in, then base
    with a multiplicative decay at each threshold in ``steps``."""
    steps = np.asarray(list(steps), np.float32)
    scales = np.asarray(list(scales), np.float32)
    f32 = np.float32

    def schedule(step) -> float:
        step = f32(step)
        warm = np.minimum((step + f32(1.0)) / f32(max(burn_in, 1)),
                          f32(1.0)) ** f32(power)
        decay = np.prod(np.where(step >= steps, scales, f32(1.0)),
                        dtype=np.float32)
        return float(f32(base_lr) * warm * decay)

    return schedule


def cosine_schedule(base_lr: float, total_steps: int, burn_in: int = 1000,
                    final_frac: float = 0.05):
    """Cosine decay alternative (not in the reference; opt-in via flag)."""
    f32 = np.float32

    def schedule(step) -> float:
        step = f32(step)
        warm = np.minimum((step + f32(1.0)) / f32(max(burn_in, 1)),
                          f32(1.0))
        t = np.clip(step / f32(max(total_steps, 1)), f32(0.0), f32(1.0))
        cos = f32(final_frac) + f32(1 - final_frac) * f32(0.5) * (
            f32(1.0) + np.cos(f32(math.pi) * t))
        return float(f32(base_lr) * warm * cos)

    return schedule
