"""Timing on the card: CUDA events around back-to-back launches.

The counterpart of the JAX package's ``x3d_tpu/ops/timing.py``.  PyTorch
returns before the device finishes, so a host clock without a synchronise
measures the enqueue; two events on the stream measure the device.  The
launches run back to back after a warm-up, and the span between the events
covers the device's work and any gap the host leaves between launches.
"""

from __future__ import annotations

from typing import Callable

import torch


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 3) -> float:
    """Seconds per ``fn(*args)`` on the current CUDA device: ``warmup``
    calls, then ``iters`` calls between two events."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_fn times the card with CUDA events; no CUDA "
                           "device is available")
    for _ in range(warmup):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters
