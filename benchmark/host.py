"""What the host did while a window ran, read from ``/proc`` (Linux; None
elsewhere), printed on stderr beside each run: the host's pace apart from
the program's.  The train cells launch thousands of kernels a step from
one thread, so their rate follows the host's speed."""

from __future__ import annotations

import os
import resource
import time
from typing import Optional


def _cpu_ticks() -> Optional[list]:
    """The machine's CPU time so far, in ticks: user, nice, system, idle,
    iowait, irq, softirq, steal."""
    try:
        with open("/proc/stat") as f:
            return [int(x) for x in f.readline().split()[1:9]]
    except (OSError, ValueError):
        return None


def _mhz() -> Optional[float]:
    """The mean clock of the host's cores, where the kernel reports it."""
    try:
        with open("/proc/cpuinfo") as f:
            vals = [float(line.split(":")[1]) for line in f
                    if line.startswith("cpu MHz")]
    except (OSError, ValueError):
        return None
    return sum(vals) / len(vals) if vals else None


def _snap() -> dict:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"t": time.perf_counter(), "ticks": _cpu_ticks(), "mhz": _mhz(),
            "cpu_s": ru.ru_utime + ru.ru_stime, "nivcsw": ru.ru_nivcsw}


class Watch:
    """Started at a window's start; ``report()`` at its end."""

    def __init__(self):
        self.start = _snap()

    def report(self) -> dict:
        a, b = self.start, _snap()
        wall = b["t"] - a["t"]
        out = {"cpus": os.cpu_count(), "load_1min": os.getloadavg()[0],
               "this_process_cpus": (b["cpu_s"] - a["cpu_s"]) / wall,
               "involuntary_switches": b["nivcsw"] - a["nivcsw"],
               "mhz_start_end": [a["mhz"], b["mhz"]]}
        if a["ticks"] and b["ticks"]:
            d = [y - x for x, y in zip(a["ticks"], b["ticks"])]
            total = sum(d) or 1
            busy = total - d[3] - d[4]
            out.update(busy_cpus=busy / os.sysconf("SC_CLK_TCK") / wall,
                       steal_share=d[7] / total)
        return out
