"""Trace a callable on the card and sum its device time by kernel group.

The shared core of ``profile_serving`` and ``profile_training``: warm up,
trace ``n`` calls with ``torch.profiler`` (device activity only, which keeps
the profiler's own host cost small), and aggregate the kernels' device time
per call, by group and by name.  Late in a long process the profiler now
and then delivers none or only part of a short window's kernels, so a
window found incomplete is taken again.
"""

from __future__ import annotations

import collections
import subprocess
from typing import Callable

import torch
from torch.autograd import DeviceType

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


class LostTrace(RuntimeError):
    """The profiler recorded no device activity, or not all of it."""


def family(name: str) -> str:
    """The kernel family of a device kernel, by its name."""
    for fam, keys in _FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


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
    windows :class:`LostTrace` is raised.  ``trace_path`` also writes a Chrome trace."""
    for _ in range(warmup):
        run()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with device_profiler() as prof:
            for _ in range(n):
                run()
            torch.cuda.synchronize()
        try:
            got = summarize(prof, n, unit, group)
        except LostTrace:
            trace.lost += 1
            continue
        if complete is None or complete(got):
            if trace_path:
                prof.export_chrome_trace(trace_path)
            return got
        trace.lost += 1
    raise LostTrace(f"the profiler lost device activity in {attempts} "
                    f"windows of {n} {unit}s")


trace.lost = 0     # windows traced again, over the process
