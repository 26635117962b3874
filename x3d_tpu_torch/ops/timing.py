"""Timing on the card: CUDA events around back-to-back launches.

The counterpart of the JAX package's ``x3d_tpu/ops/timing.py``.  PyTorch
returns before the device finishes, so a host clock without a synchronise
measures the enqueue; two events on the stream measure the device.  The
launches run back to back after a warm-up, and the span between the events
covers the device's work and any gap the host leaves between launches.
``device_time_fn`` holds the stream first, so that the host's gaps do not
count.
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


def device_time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 3,
                   hold_cycles: int = 2_000_000) -> float:
    """Seconds per ``fn(*args)`` of the device's own time: a spinning
    kernel holds the stream while the host enqueues ``iters`` calls, so the
    span between the two events covers the calls' kernels and the gaps the
    device leaves between them, but none the host leaves.  Where the hold
    ended before the host had enqueued every call, it is taken again four
    times as long (at most four times in all).  ``fn`` must not
    synchronise."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_time_fn times the card with CUDA events; "
                           "no CUDA device is available")
    for _ in range(warmup):
        fn(*args)
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(hold_cycles)
        start.record()
        for _ in range(iters):
            fn(*args)
        held = not start.query()
        end.record()
        end.synchronize()
        if held:
            return start.elapsed_time(end) / 1e3 / iters
        hold_cycles *= 4
    raise RuntimeError(f"the device reached the calls before the host had "
                       f"enqueued {iters} of them, with a hold of "
                       f"{hold_cycles // 4} cycles")
