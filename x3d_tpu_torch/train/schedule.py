"""Learning-rate schedule: linear warmup, then half-cosine, stepped per epoch.

The LR is constant within an epoch.  The first ``WARMUP_EPOCHS`` epochs
interpolate linearly from WARMUP_LR to BASE_LR, and strictly *after* epoch
WARMUP_EPOCHS the half-cosine ``BASE_LR * 0.5 * (cos(pi * epoch / EPOCHS) +
1)`` applies: epoch == WARMUP_EPOCHS still uses the warmup line (which there
equals BASE_LR), as the reference and the JAX package do
(``x3d_tpu/train/schedule.py``).  Values are computed in float32, as there.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np


def lr_for_epoch(cfg, epoch: int) -> float:
    """LR for a 0-based epoch index."""
    t = cfg.TRAIN
    f32 = np.float32
    e = f32(epoch)
    if e > f32(t.WARMUP_EPOCHS):
        return float(f32(t.BASE_LR) * f32(0.5)
                     * (np.cos(f32(math.pi) * e / f32(t.EPOCHS)) + f32(1.0)))
    return float(f32(t.WARMUP_LR) + e * (f32(t.BASE_LR) - f32(t.WARMUP_LR))
                 / f32(t.WARMUP_EPOCHS))


def make_lr_schedule(cfg, steps_per_epoch: int) -> Callable[[int], float]:
    """step -> LR, with epoch = step // steps_per_epoch: the per-epoch
    staircase as a function of the global step."""
    if steps_per_epoch <= 0:
        raise ValueError("steps_per_epoch must be positive")

    def schedule(step: int) -> float:
        return lr_for_epoch(cfg, int(step) // steps_per_epoch)

    return schedule
