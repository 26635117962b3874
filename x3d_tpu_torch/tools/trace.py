"""Trace a callable on the card and sum its device time by kernel group.

The shared core of ``profile_serving`` and ``profile_training``: warm up,
trace ``n`` calls with ``torch.profiler`` (device activity only, which keeps
the profiler's own host cost small), and aggregate the kernels' device time
per call, by group and by name.  Late in a long process the profiler now
and then delivers none or only part of a short window's kernels, so a
window found incomplete is taken again.

It also names the port's kernels (:data:`PORT_GROUPS`, :func:`port_group`)
and ties a window's kernels to the wrappers' launch log
(``ops.launch_log``): each record's main kernel -- the launch's first
kernel, not its second pass that sums partials -- lies in the group
:func:`record_group` names, and :func:`unmatched` finds the groups whose
main kernels and records differ in number.  A traced window written to a
file keeps its log beside it as ``launches.json``.

The window's spans (``ops.span_log``: the engine's request and the train
step, by phase) are mapped onto the trace's timeline (:func:`span_times`)
by anchors taken on both clocks at each end of the window
(:func:`anchor`, :func:`clock`), which follow a host clock that runs fast
or slow against the card's timestamps: the summary gains each span's host
ms a call and the device's idle ms by the innermost span open on the host
(:func:`by_span`), and a window written to a file carries them as a host
thread of the Chrome trace and as ``spans.json``.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import math
import os
import subprocess
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch.autograd import DeviceType

from x3d_tpu_torch import ops

# the input pipeline's kernels: the clip kernel and nvJPEG's decode
INPUT_KERNELS = ("clip_prep_kernel", "nvjpeg", "Nvjpeg", "NVJPEG")

_FAMILIES = (
    ("input", INPUT_KERNELS),
    ("port kernels", ("dw_conv3d", "dw_bn_act_conv", "sum_partials",
                      "sum_dk_partials", "sum_pbwd_partials",
                      "pw_stats_kernel", "pw_conv_", "pw_act_conv_stats",
                      "fma_chain")),
    ("cudnn conv", ("convolve", "cudnn")),
    ("gemm", ("gemm", "cutlass", "xmma", "sm90_", "cublas")),
    ("reduction", ("reduce", "Reduce")),
    ("copy", ("copy", "Memcpy", "Memset", "cat")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


# the port's kernels by the names of their __global__ functions
PORT_GROUPS = (
    ("K1 depthwise_conv3d", ("dw_conv3d_fwd_kernel",
                             "dw_conv3d_fwd_temporal_kernel",
                             "dw_conv3d_fwd_ring_kernel")),
    ("K2 dw_bn_act_conv", ("dw_bn_act_conv_fwd_kernel",
                           "dw_bn_act_conv_fwd_ring_kernel",
                           "dw_bn_act_conv_fwd_sum_kernel")),
    ("K3 dw_bn_act_conv_bwd", ("dw_bn_act_conv_bwd_kernel",
                                "dw_bn_act_conv_bwd_ring_kernel",
                                "dw_bn_act_conv_bwd_sum_kernel")),
    ("K4 depthwise_conv3d_dx", ("dw_conv3d_dx_kernel",
                                "dw_conv3d_dx_phase_kernel")),
    ("K4 depthwise_conv3d_dk", ("dw_conv3d_dk_kernel",
                                "sum_dk_partials_kernel",
                                "dw_conv3d_dk_ring_kernel",
                                "dw_conv3d_dk_sum_kernel")),
    ("K5 pw_conv_stats", ("pw_conv_stats_mma_kernel",)),
    ("K6 pw_act_conv_stats", ("pw_act_conv_stats_mma_kernel",)),
    ("K5/K6 pw_stats", ("pw_stats_kernel",)),          # float32, odd K
    ("K7 pw_conv", ("pw_conv_kernel", "pw_conv_mma_kernel",
                    "pw_conv_wg_kernel")),
    ("K8 depthwise_conv3d_pbwd", ("dw_conv3d_pbwd_kernel",
                                  "sum_pbwd_partials_kernel",
                                  "dw_conv3d_pbwd_temporal_kernel",
                                  "dw_conv3d_pbwd_sum_kernel")),
    ("K2/K3/K5/K6 second passes", ("sum_partials_kernel",)),
    ("input", INPUT_KERNELS),
)
# the second passes that sum a launch's partials ("sum_partials_kernel",
# "sum_dk_partials_kernel", "dw_conv3d_dk_sum_kernel", ...)
SECOND_PASSES = ("partials_kernel", "_sum_kernel")
# a log record's kernel -> its main kernel's group (K5 and K6 off their
# tensor-core body run pw_stats_kernel: record_group)
RECORD_GROUPS = {"K1": "K1 depthwise_conv3d", "K2": "K2 dw_bn_act_conv",
                 "K3": "K3 dw_bn_act_conv_bwd",
                 "K4 dx": "K4 depthwise_conv3d_dx",
                 "K4 dk": "K4 depthwise_conv3d_dk",
                 "K5": "K5 pw_conv_stats", "K6": "K6 pw_act_conv_stats",
                 "K7": "K7 pw_conv", "K8": "K8 depthwise_conv3d_pbwd"}


class LostTrace(RuntimeError):
    """The profiler recorded no device activity, or not all of it."""


LAUNCHES = "launches.json"     # the launch log beside a Chrome trace
SPANS = "spans.json"           # and the spans, on the trace's clock
OUTSIDE = "outside spans"      # device idle time with no span open
CARD = "card.txt"              # and the card's name and power limit
# the anchors' kernel (``torch.cuda._sleep``'s), kept out of a window's
# operations, and its length: about half a µs
ANCHOR = "spin_kernel"
ANCHOR_CYCLES = 1000
# Seconds the host waits, idle, after a profiler starts and before it
# stops, in each attempt at a window that keeps a launch log.  Late in a
# long process (13 minutes in) the profiler dropped the first kernels of
# such windows, the first K1 and K7 of an X3D-M step, with no wait and
# after waits of 0.05 and 0.5 s, and kept them all after 2 s; the wait
# keeps the window's work clear of both of its ends.
SETTLE_S = (2.0, 4.0, 8.0)


def device_events(prof) -> list:
    """The window's device operations in time order, the clock's anchors
    (:data:`ANCHOR` kernels) left out."""
    return sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and ANCHOR not in e.name),
                  key=lambda e: e.time_range.start)


def _kernel_names(prof) -> list:
    """The window's device kernels' names, in time order."""
    return [e.name for e in device_events(prof)]


def family(name: str) -> str:
    """The kernel family of a device kernel, by its name."""
    for fam, keys in _FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def port_group(name: str) -> str:
    """The group of a device kernel: one of the port's kernels
    (:data:`PORT_GROUPS`), else its library family (:func:`family`)."""
    for group, keys in PORT_GROUPS:
        if any(k in name for k in keys):
            return group
    return family(name)


def main_group(name: str) -> Optional[str]:
    """The K group of a port kernel that is a launch's main kernel; None
    for a second pass, a library kernel or the input's kernels."""
    group = port_group(name)
    if not group.startswith("K") or "second passes" in group \
            or any(k in name for k in SECOND_PASSES):
        return None
    return group


def record_group(record: dict) -> str:
    """The group of the main kernel a launch-log record's call ran."""
    if record["kernel"] in ("K5", "K6") and record["body"] == "cuda_core":
        return "K5/K6 pw_stats"
    return RECORD_GROUPS[record["kernel"]]


def unmatched(kernel_names: Iterable[str],
              records: Iterable[dict]) -> Dict[str, tuple]:
    """{group: (main kernels, log records)} for each group whose main
    kernels in a window and launch-log records of the calls differ in
    number; empty where every group matches.  Records of the plain
    versions (no kernel) are left out."""
    kern = collections.Counter(g for g in map(main_group, kernel_names) if g)
    logged = collections.Counter(record_group(r) for r in records
                                 if r["body"] != "plain")
    return {g: (kern[g], logged[g]) for g in sorted(set(kern) | set(logged))
            if kern[g] != logged[g]}


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else torch.cuda.get_device_name(0)


def device_profiler() -> torch.profiler.profile:
    """A profiler that records device activity only (which keeps its own
    host cost small); use as a context manager or start()/stop()."""
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA], acc_events=True)


def union(intervals: Iterable[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    """The union of intervals, as disjoint intervals in time order."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def summarize(prof: torch.profiler.profile, n: int, unit: str,
              group: Callable[[str], str] = family) -> dict:
    """Aggregate a finished device trace of ``n`` calls: the kernels'
    summed device time, the traced window and the number of kernels per
    call (keys ending in ``_per_<unit>``), the device's idle share between
    the first and the last kernel (one less the union of the kernels'
    intervals over that span: kernels that overlap on two streams count
    once), device time and kernels per call by ``group(kernel name)``, and
    the top 15 kernels by name.  The clock's anchors are left out."""
    kernels = device_events(prof)
    if not kernels:
        raise LostTrace("the profiler recorded no device activity")
    start = min(e.time_range.start for e in kernels)
    end = max(e.time_range.end for e in kernels)
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    covered = sum(b - a for a, b in union(
        (e.time_range.start, e.time_range.end) for e in kernels))
    by_name, by_group = collections.Counter(), collections.Counter()
    count = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
        by_group[group(e.name)] += e.time_range.elapsed_us()
        count[group(e.name)] += 1
    per = f"_per_{unit}"
    key = "family" if group is family else "group"
    return {
        "device_busy_ms" + per: busy / n / 1e3,
        "window_ms" + per: (end - start) / n / 1e3,
        "idle_share": 1.0 - covered / (end - start),
        "kernels" + per: len(kernels) / n,
        key + "_ms" + per:
            {k: v / n / 1e3 for k, v in by_group.most_common()},
        key + "_kernels" + per: {k: v / n for k, v in count.most_common()},
        "top_kernels_ms" + per: [[name[:90], v / n / 1e3]
                                 for name, v in by_name.most_common(15)],
    }


def anchor(k: int = 3) -> List[Tuple[int, int]]:
    """Tie the host's clock to the card's at this instant, ``k`` times: a
    synchronize, the host's time, one :data:`ANCHOR` kernel, a synchronize
    and the host's time again, so that the kernel ran between the two host
    times.  Returns the ``k`` pairs of ``time.time_ns()``; none with no
    card."""
    if not torch.cuda.is_available():
        return []
    pairs = []
    for _ in range(k):
        torch.cuda.synchronize()
        before = time.time_ns()
        torch.cuda._sleep(ANCHOR_CYCLES)
        torch.cuda.synchronize()
        pairs.append((before, time.time_ns()))
    return pairs


def clock(prof, anchors: Iterable[List[Tuple[int, int]]] = ()
          ) -> Tuple[Callable[[int], float], dict]:
    """The map from the host's ``time.time_ns()`` to µs on the profiler's
    timeline (the one its events' ``time_range`` is on), and what it read
    of the clocks.  ``anchors`` are groups of :func:`anchor` pairs, one
    group at each end of the window, matched in order to the window's
    :data:`ANCHOR` kernels.  A pair bounds the card's offset from the host
    from both sides (its kernel starts after the first host time and ends
    before the second); a group's offset is the middle of its tightest
    bounds, ``clock_error_us`` the widest group's half-width; between the
    groups the offset moves in a line, whose slope is ``clock_drift_ppm``
    (above 0: the card's timestamps run fast against the host's clock).
    With no anchors (no card: a CPU trace, whose events are on the host's
    clock) the offset is ``trace_start_ns()``'s.  Raises
    :class:`LostTrace` where the window lacks some of the anchors'
    kernels."""
    t0 = prof.profiler.kineto_results.trace_start_ns()
    groups = [g for g in anchors if g]
    if not groups:
        return (lambda ns: (ns - t0) / 1e3), {}
    marks = sorted((e for e in prof.events()
                    if e.device_type == DeviceType.CUDA and ANCHOR in e.name),
                   key=lambda e: e.time_range.start)
    if len(marks) != sum(map(len, groups)):
        raise LostTrace(f"{len(marks)} anchor kernels in the window for "
                        f"{sum(map(len, groups))} anchors")
    points, widths, marks = [], [], iter(marks)
    for group in groups:
        lo, hi = -math.inf, math.inf
        for before, after in group:
            e = next(marks)
            lo = max(lo, e.time_range.end - (after - t0) / 1e3)
            hi = min(hi, e.time_range.start - (before - t0) / 1e3)
        points.append(((group[0][0] + group[-1][1]) / 2e3 - t0 / 1e3,
                       (lo + hi) / 2))
        widths.append(abs(hi - lo) / 2)
    (h_a, o_a), (h_b, o_b) = points[0], points[-1]
    slope = (o_b - o_a) / (h_b - h_a) if h_b != h_a else 0.0

    def to_us(ns: int) -> float:
        h = (ns - t0) / 1e3
        return h + o_a + (h - h_a) * slope

    return to_us, {"clock_drift_ppm": slope * 1e6,
                   "clock_error_us": max(widths)}


def span_times(prof, records: List[dict],
               anchors: Iterable[List[Tuple[int, int]]] = ()) -> List[dict]:
    """The closed spans of ``ops.span_log`` records, each with ``start_us``
    and ``end_us`` on the profiler's timeline (by :func:`clock` and the
    window's ``anchors``) and its nesting ``depth`` (0 outermost)."""
    to_us, _ = clock(prof, anchors)
    depth = {}
    out = []
    for r in records:
        if r["end_ns"] is None:
            continue
        depth[r["id"]] = depth.get(r["parent"], -1) + 1
        out.append(dict(r, start_us=to_us(r["start_ns"]),
                        end_us=to_us(r["end_ns"]), depth=depth[r["id"]]))
    return out


def innermost(spans: List[dict], t: float) -> Optional[dict]:
    """The deepest span open at ``t`` (µs), the later opened on a tie."""
    best = None
    for s in spans:
        if s["start_us"] <= t < s["end_us"] and (
                best is None or (s["depth"], s["start_us"])
                >= (best["depth"], best["start_us"])):
            best = s
    return best


def by_span(kernels: Iterable[Tuple[float, float]], spans: List[dict],
            n: int, unit: str) -> dict:
    """From the device's (start, end) intervals and :func:`span_times`
    (all in µs), per call: the host ms spent inside each span by name, and
    the device's idle ms by the innermost span open on the host at each
    instant (:data:`OUTSIDE` where none is), over the window from the
    first kernel or span to the last.  An outer span's own row holds only
    the idle time outside its children: the idle time inside it is its row
    and its descendants' rows together."""
    busy = union(kernels)
    ends = [t for a, b in busy for t in (a, b)] \
        + [t for s in spans for t in (s["start_us"], s["end_us"])]
    per = f"_per_{unit}"
    host = collections.Counter()
    for s in spans:
        host[s["name"]] += s["end_us"] - s["start_us"]
    idle = collections.Counter()
    if ends:
        lo, hi = min(ends), max(ends)
        gaps, t = [], lo
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        cuts = sorted({t for s in spans for t in (s["start_us"],
                                                  s["end_us"])})
        for a, b in gaps:
            i = bisect.bisect_right(cuts, a)
            points = [a]
            while i < len(cuts) and cuts[i] < b:
                points.append(cuts[i])
                i += 1
            points.append(b)
            for x, y in zip(points, points[1:]):
                inner = innermost(spans, (x + y) / 2)
                idle[inner["name"] if inner else OUTSIDE] += y - x
    return {"span_host_ms" + per: {k: v / n / 1e3
                                   for k, v in host.most_common()},
            "span_idle_ms" + per: {k: v / n / 1e3
                                   for k, v in idle.most_common()}}


def span_summary(prof, records: List[dict],
                 anchors: Iterable[List[Tuple[int, int]]], n: int,
                 unit: str) -> Tuple[List[dict], dict]:
    """A finished window's closed spans (:func:`span_times`) and the keys
    they add to its summary: :func:`by_span`'s over the window's device
    operations, and the clock's (:func:`clock`); none without spans."""
    spans = span_times(prof, records, anchors) if records else []
    if not spans:
        return [], {}
    got = by_span(((e.time_range.start, e.time_range.end)
                   for e in device_events(prof)), spans, n, unit)
    got.update(clock(prof, anchors)[1])
    return spans, got


def chrome_spans(path: str, prof, spans: List[dict]) -> None:
    """Add the spans to the Chrome trace at ``path`` as a host thread of
    their own, on the trace's clock (its ``ts`` lie at a fixed offset from
    the profiler's timeline, read off the first device event); a trace
    without that event is left as it is."""
    with open(path) as f:
        chrome = json.load(f)
    events = chrome["traceEvents"]
    device = device_events(prof)
    if not device:
        return
    first = device[0]
    ts = [e["ts"] for e in events
          if e.get("ph") == "X" and e.get("name") == first.name]
    if not ts:
        return
    offset = min(ts) - first.time_range.start
    pid, tid = os.getpid(), "spans"
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                   "args": {"name": "x3d_tpu_torch spans"}})
    for s in spans:
        args = {k: v for k, v in s.items()
                if k not in ("name", "start_ns", "end_ns", "start_us",
                             "end_us")}
        events.append({"ph": "X", "cat": "span", "name": s["name"],
                       "pid": pid, "tid": tid, "ts": s["start_us"] + offset,
                       "dur": s["end_us"] - s["start_us"], "args": args})
    with open(path, "w") as f:
        json.dump(chrome, f)


def trace(run: Callable[[], object], n: int, unit: str,
          group: Callable[[str], str] = family,
          trace_path: str | None = None, warmup: int = 2,
          complete: Callable[[dict], bool] | None = None,
          attempts: int = 3) -> dict:
    """Call ``run`` ``warmup`` times, then trace ``n`` calls and return
    their :func:`summarize`.  A window with no device activity, or whose
    summary ``complete`` rejects (fewer kernels than the calls launch), is
    traced again and counted in ``trace.lost``; after ``attempts`` such
    windows :class:`LostTrace` is raised.  Where the calls made spans
    (``ops.span_log``, open over the window), the summary gains
    :func:`span_summary`'s keys, the spans mapped by anchors taken just
    before the first call and just after the last (:func:`anchor`).
    ``trace_path`` also writes a Chrome trace with the spans as a host
    thread, and beside it, as ``launches.json``, the window's launch log
    (``ops.launch_log``, kept over the window alone) and as ``spans.json``
    its spans; a window whose main kernels the log does not match group by
    group (:func:`unmatched`) is traced again too; the card's name and
    power limit go into ``card.txt`` there; such a window's work starts
    and ends ``SETTLE_S[attempt]`` seconds inside the profiler's span."""
    for _ in range(warmup):
        run()
    torch.cuda.synchronize()
    keep = contextlib.nullcontext if trace_path is None else ops.launch_log
    off = {}
    for attempt in range(attempts):
        settle = SETTLE_S[min(attempt, len(SETTLE_S) - 1)] \
            if trace_path else 0.0
        with keep() as records, ops.span_log() as marks, \
                device_profiler() as prof:
            time.sleep(settle)
            anchors = [anchor()]
            for _ in range(n):
                run()
            anchors.append(anchor())
            torch.cuda.synchronize()
            time.sleep(settle)
        try:
            got = summarize(prof, n, unit, group)
            spans, keys = span_summary(prof, marks, anchors, n, unit)
        except LostTrace:
            trace.lost += 1
            continue
        names = _kernel_names(prof) if trace_path else []
        off = unmatched(names, records) if trace_path else {}
        if off:
            first = next((g for g in map(main_group, names) if g), None)
            off["window's first main kernel, log's first"] = (
                first, records and record_group(records[0]))
            trace.lost += 1
            continue
        if complete is None or complete(got):
            got.update(keys)
            if trace_path:
                prof.export_chrome_trace(trace_path)
                if spans:
                    chrome_spans(trace_path, prof, spans)
                where = os.path.dirname(trace_path) or "."
                with open(os.path.join(where, LAUNCHES), "w") as f:
                    json.dump(records, f)
                with open(os.path.join(where, SPANS), "w") as f:
                    json.dump(spans, f)
                with open(os.path.join(where, CARD), "w") as f:
                    f.write(card() + "\n")
            return got
        trace.lost += 1
    raise LostTrace(f"the profiler lost device activity in {attempts} "
                    f"windows of {n} {unit}s" + (
                        f"; the last window's main kernels against the "
                        f"launch log, by group: {off}" if off else ""))


trace.lost = 0     # windows traced again, over the process
