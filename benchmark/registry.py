"""Where the harness finds a cell's parts: each by its name, in a file of
its own.

* the cells and metrics: ``BENCHMARK.json`` at the checkout's root;
* a configuration: ``benchmark/configs/<config>.json``;
* a traffic mix: ``benchmark/traffic/<traffic>.json``, of a ``kind`` the
  harness drives and with no key that it does not read (``TRAFFIC_KEYS``);
* a cell's correctness limits: ``benchmark/limits/<workload>.json``;
* a per-layer metric: ``benchmark/metrics/<metric>.py``, whose
  ``read(ctx)`` returns the number or None;
* a kernel class: every ``benchmark/kernel_classes/*.json``, each naming
  its ``class`` and the name ``patterns`` of its kernels (a class may have
  several files).

A later cell, metric or class is one more file and one more entry.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os
from typing import Callable, Dict, List, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))

# the keys of a traffic mix that the harness reads, by the mix's kind
TRAFFIC_KEYS = {
    "train": {"kind", "why", "clips", "ranks", "pool", "ref_steps", "warm"},
    "serve": {"kind", "why", "videos", "pool"},
}


class Bench:
    def __init__(self, root: str):
        self.root = root
        self.dir = os.path.join(root, "benchmark")
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)

    def _json(self, kind: str, name: str) -> dict:
        with open(os.path.join(self.dir, kind, f"{name}.json")) as f:
            return json.load(f)

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        """A traffic mix; one of a kind, or with a key, that the harness
        does not drive is refused rather than run as something else."""
        mix = self._json("traffic", name)
        kind = mix.get("kind")
        if kind not in TRAFFIC_KEYS:
            raise ValueError(f"traffic {name!r}: no driver for kind {kind!r}")
        unread = sorted(set(mix) - TRAFFIC_KEYS[kind])
        if unread:
            raise ValueError(f"traffic {name!r}: keys the {kind} driver does "
                             f"not read: {unread}")
        return mix

    def limits(self, workload: str) -> dict:
        return self._json("limits", workload)

    def _reports(self, metric: dict, workload: str) -> bool:
        if "workloads" in metric:
            return workload in metric["workloads"]
        return any(workload in m.get("workloads", [workload])
                   for m in self.spec["end_to_end"]
                   if m["name"] == metric["moves"])

    def end_to_end(self, workload: str) -> List[dict]:
        return [m for m in self.spec["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> List[dict]:
        return [m for m in self.spec["per_layer"]
                if self._reports(m, workload)]

    def reader(self, metric: str) -> Callable:
        path = os.path.join(self.dir, "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(
            f"benchmark_metric_{metric.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

    def kernel_classes(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {}
        for path in sorted(glob.glob(os.path.join(self.dir, "kernel_classes",
                                                  "*.json"))):
            with open(path) as f:
                d = json.load(f)
            out.setdefault(d["class"], []).extend(d["patterns"])
        return out


def classify(name: str, classes: Dict[str, List[str]]) -> Tuple[str, ...]:
    """The classes of a device operation by its name: each class with a
    pattern inside the name, in the order of their files.  A kernel that
    does two classes' work (a second pass that two kernels share) is listed
    in both and counts in both."""
    return tuple(cls for cls, patterns in classes.items()
                 if any(p in name for p in patterns))
