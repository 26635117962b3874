"""Learning-rate schedule: linear warmup, then half-cosine, stepped per epoch.

The LR is constant within an epoch.  The first ``WARMUP_EPOCHS`` epochs
interpolate linearly from WARMUP_LR to BASE_LR, and strictly *after* epoch
WARMUP_EPOCHS the half-cosine ``BASE_LR * 0.5 * (cos(pi * epoch / EPOCHS) +
1)`` applies: epoch == WARMUP_EPOCHS still uses the warmup line (which there
equals BASE_LR), as the reference and the JAX package do
(``x3d_tpu/train/schedule.py``).

Values are the JAX package's to the last bit: each operation in float32, in
its order, the config's Python floats combined in double before they meet
the float32 epoch (``BASE_LR - WARMUP_LR``, ``BASE_LR * 0.5``), and the
cosine of a float32 as the C library's ``cosf`` computes it, which is what
XLA's CPU backend calls (numpy's float32 cosine differs from it in the last
bit now and then).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
from typing import Callable

import numpy as np


@functools.lru_cache(maxsize=None)
def _libm_cosf():
    fn = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6").cosf
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return fn


def cosf(x: np.float32) -> np.float32:
    """cos of a float32, in float32, by the C library's ``cosf``."""
    return np.float32(_libm_cosf()(float(np.float32(x))))


def lr_for_epoch(cfg, epoch: int) -> float:
    """LR for a 0-based epoch index."""
    t = cfg.TRAIN
    f32 = np.float32
    e = f32(epoch)
    if e > f32(t.WARMUP_EPOCHS):
        angle = f32(math.pi) * e / f32(t.EPOCHS)
        return float(f32(t.BASE_LR * 0.5) * (cosf(angle) + f32(1.0)))
    return float(f32(t.WARMUP_LR) + e * f32(t.BASE_LR - t.WARMUP_LR)
                 / f32(t.WARMUP_EPOCHS))


def make_lr_schedule(cfg, steps_per_epoch: int) -> Callable[[int], float]:
    """step -> LR, with epoch = step // steps_per_epoch: the per-epoch
    staircase as a function of the global step."""
    if steps_per_epoch <= 0:
        raise ValueError("steps_per_epoch must be positive")

    def schedule(step: int) -> float:
        return lr_for_epoch(cfg, int(step) // steps_per_epoch)

    return schedule
