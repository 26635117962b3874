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
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import subprocess
import time
from typing import Callable, Dict, Iterable, Optional

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
CARD = "card.txt"              # and the card's name and power limit
# Seconds the host waits, idle, after a profiler starts and before it
# stops, in each attempt at a window that keeps a launch log.  Late in a
# long process (13 minutes in) the profiler dropped the first kernels of
# such windows, the first K1 and K7 of an X3D-M step, with no wait and
# after waits of 0.05 and 0.5 s, and kept them all after 2 s; the wait
# keeps the window's work clear of both of its ends.
SETTLE_S = (2.0, 4.0, 8.0)


def _kernel_names(prof) -> list:
    """The window's device kernels' names, in time order."""
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return [e.name for e in sorted(kernels,
                                   key=lambda e: e.time_range.start)]


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


def summarize(prof: torch.profiler.profile, n: int, unit: str,
              group: Callable[[str], str] = family) -> dict:
    """Aggregate a finished device trace of ``n`` calls: the device busy
    time, the traced window and the number of kernels per call (keys ending
    in ``_per_<unit>``), the device's idle share between the first and the
    last kernel, device time and kernels per call by ``group(kernel
    name)``, and the top 15 kernels by name."""
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise LostTrace("the profiler recorded no device activity")
    start = min(e.time_range.start for e in kernels)
    end = max(e.time_range.end for e in kernels)
    busy = sum(e.time_range.elapsed_us() for e in kernels)
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
        "idle_share": 1.0 - busy / (end - start),
        "kernels" + per: len(kernels) / n,
        key + "_ms" + per:
            {k: v / n / 1e3 for k, v in by_group.most_common()},
        key + "_kernels" + per: {k: v / n for k, v in count.most_common()},
        "top_kernels_ms" + per: [[name[:90], v / n / 1e3]
                                 for name, v in by_name.most_common(15)],
    }


def trace(run: Callable[[], object], n: int, unit: str,
          group: Callable[[str], str] = family,
          trace_path: str | None = None, warmup: int = 2,
          complete: Callable[[dict], bool] | None = None,
          attempts: int = 3) -> dict:
    """Call ``run`` ``warmup`` times, then trace ``n`` calls and return
    their :func:`summarize`.  A window with no device activity, or whose
    summary ``complete`` rejects (fewer kernels than the calls launch), is
    traced again and counted in ``trace.lost``; after ``attempts`` such
    windows :class:`LostTrace` is raised.  ``trace_path`` also writes a
    Chrome trace, and beside it, as ``launches.json``, the window's launch
    log (``ops.launch_log``, kept over the window alone); a window whose
    main kernels the log does not match group by group (:func:`unmatched`)
    is traced again too; the card's name and power limit go into
    ``card.txt`` there; such a window's work starts and ends
    ``SETTLE_S[attempt]`` seconds inside the profiler's span."""
    for _ in range(warmup):
        run()
    torch.cuda.synchronize()
    keep = contextlib.nullcontext if trace_path is None else ops.launch_log
    off = {}
    for attempt in range(attempts):
        settle = SETTLE_S[min(attempt, len(SETTLE_S) - 1)] \
            if trace_path else 0.0
        with keep() as records, device_profiler() as prof:
            time.sleep(settle)
            for _ in range(n):
                run()
            torch.cuda.synchronize()
            time.sleep(settle)
        try:
            got = summarize(prof, n, unit, group)
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
            if trace_path:
                prof.export_chrome_trace(trace_path)
                where = os.path.dirname(trace_path) or "."
                with open(os.path.join(where, LAUNCHES), "w") as f:
                    json.dump(records, f)
                with open(os.path.join(where, CARD), "w") as f:
                    f.write(card() + "\n")
            return got
        trace.lost += 1
    raise LostTrace(f"the profiler lost device activity in {attempts} "
                    f"windows of {n} {unit}s" + (
                        f"; the last window's main kernels against the "
                        f"launch log, by group: {off}" if off else ""))


trace.lost = 0     # windows traced again, over the process
