"""The arithmetic of the per-layer metrics, over a traced window.

Each metric file under ``benchmark/metrics/`` calls one of these on the
``Context`` of its cell and returns None where it has nothing to read.
Shares are in percent.  Work and operations come from ``work.py``'s shape
arithmetic, device time from the trace: never from the program's own
counters.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from benchmark import work
from benchmark.trace import Window


@dataclass
class Context:
    kind: str              # "train" or "serve"
    window: Window
    network: dict          # the configuration's NETWORK group
    clips: int             # clips a call (a step, a request) on this chip
    frames: int
    size: int

    @property
    def calls(self) -> int:
        return self.window.calls

    def class_seconds(self, cls: str) -> float:
        return self.window.seconds_by_class().get(cls, 0.0)


def idle_share(ctx: Context) -> float:
    w = ctx.window
    return 100.0 * (1.0 - w.busy_s / w.window_s)


def mfu(ctx: Context) -> float:
    """The model's operations done in the window (a training step three
    times the forward's, nothing recomputed counted) over the window at
    the dense bf16 peak."""
    passes = 3 if ctx.kind == "train" else 1
    flops = passes * ctx.calls * work.forward_flops(
        ctx.network, ctx.clips, ctx.frames, ctx.size)
    return 100.0 * flops / (ctx.window.window_s * work.BF16_FLOPS)


def roofline(ctx: Context, cls: str) -> Optional[float]:
    """The least time of the class's work in the window over the device
    time of the class's kernels."""
    spent = ctx.class_seconds(cls)
    if spent <= 0:
        return None
    least = ctx.calls * work.least_seconds(
        ctx.network, ctx.clips, ctx.frames, ctx.size, ctx.kind == "train",
        cls)
    return 100.0 * least / spent


def ms_per_call(ctx: Context, cls: Optional[str]) -> float:
    return 1e3 * ctx.window.seconds_by_class().get(cls, 0.0) / ctx.calls


def launches(ctx: Context) -> float:
    return len(ctx.window.ops) / ctx.calls
