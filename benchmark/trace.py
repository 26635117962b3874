"""A traced window on the device and what the metrics read from it.

``profile_calls`` traces ``n`` calls of the timed path with
``torch.profiler`` (device activity only, which keeps the profiler's host
cost small), a one-thread marker kernel (``torch.cuda._sleep``) on the
stream before each call and after the last.  The markers cut the device
timeline into calls and bound the window: from the first marker's start
to the last one's end.  A window where the calls launch different numbers
of operations (the profiler now and then drops part of a window) is
traced again.

``Window`` holds the operations and reduces them: the device's busy time
is the union of the operations' intervals, so operations that overlap on
two streams count once; time by class sums the operations' own durations
(an operation of two classes counts in both).
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.autograd import DeviceType

from benchmark.registry import classify

MARKER = "spin_kernel"
SETTLE_S = 0.5


class LostTrace(RuntimeError):
    """The profiler recorded no device activity, or not all of it."""


@dataclass
class Op:
    name: str
    start: float      # seconds on the device's timeline
    end: float
    call: int         # which traced call launched it

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class Window:
    ops: List[Op]
    calls: int
    start: float
    end: float
    span: str = "call"                 # the harness's name of a call
    classes: Dict[str, List[str]] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for op in sorted(self.ops, key=lambda o: o.start):
            if merged and op.start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], op.end)
            else:
                merged.append([op.start, op.end])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def seconds_by_class(self) -> Dict[Optional[str], float]:
        """Device seconds by kernel class, None for operations of no class;
        an operation of two classes counts in both."""
        out: Dict[Optional[str], float] = collections.Counter()
        for op in self.ops:
            for cls in classify(op.name, self.classes) or (None,):
                out[cls] += op.seconds
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The operations that took most device time, and the longest idle
        gaps summed by what the host was in: a call (named by the
        operation the device waited for) or between calls."""
        by_name: Dict[str, float] = collections.Counter()
        for op in self.ops:
            by_name[op.name[:160]] += op.seconds
        ops = sorted(self.ops, key=lambda o: o.start)
        gaps: Dict[str, float] = collections.Counter()
        busy_until, last_call = self.start, 0
        for op in ops:
            if op.start > busy_until:
                where = "between calls" if op.call != last_call else \
                    f"{self.span}: before {op.name[:120]}"
                gaps[where] += op.start - busy_until
            busy_until = max(busy_until, op.end)
            last_call = op.call
        if self.end > busy_until:
            gaps["between calls"] += self.end - busy_until
        return {"device_ops": [[k, v] for k, v in
                               sorted(by_name.items(), key=lambda kv: -kv[1])
                               [:top]],
                "idle_gaps": [[k, v] for k, v in
                              sorted(gaps.items(), key=lambda kv: -kv[1])
                              [:top]]}


def _marker() -> None:
    torch.cuda._sleep(1)


def _window(prof, n: int) -> Window:
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    marks = [e for e in events if MARKER in e.name]
    if len(marks) != n + 1:
        raise LostTrace(f"{len(marks)} markers for {n} calls")
    bounds = [m.time_range.start / 1e6 for m in marks]
    ops = []
    for e in events:
        if MARKER in e.name:
            continue
        t0, t1 = e.time_range.start / 1e6, e.time_range.end / 1e6
        call = sum(1 for b in bounds[1:] if t0 >= b)
        ops.append(Op(e.name, t0, t1, min(call, n - 1)))
    counts = collections.Counter(op.call for op in ops)
    if not ops or len({counts[c] for c in range(n)}) != 1:
        raise LostTrace(f"operations a call: {[counts[c] for c in range(n)]}")
    return Window(ops, n, marks[0].time_range.start / 1e6,
                  marks[-1].time_range.end / 1e6)


def profile_calls(call: Callable[[], object], n: int,
                  attempts: int = 3) -> Window:
    """Trace ``n`` calls; retake a window whose calls launched different
    numbers of operations."""
    last = None
    for _ in range(attempts):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA],
                acc_events=True) as prof:
            time.sleep(SETTLE_S)
            for _ in range(n):
                _marker()
                call()
            _marker()
            torch.cuda.synchronize()
            time.sleep(SETTLE_S)
        try:
            return _window(prof, n)
        except LostTrace as e:
            last = e
    raise LostTrace(f"no whole window in {attempts} attempts: {last}")
