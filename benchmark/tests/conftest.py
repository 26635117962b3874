"""Fixtures of the benchmark's tests: a copy of the benchmark with a tiny
configuration, traffic mixes, limits, a metric and a kernel class added
as new files, which the harness finds by name."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_NETWORK = {"C1_TEMP_FILTER": 5, "C1_CHANNELS": 4, "SCALE_RES2": False,
                "WIDTH_FACTOR": 1.0, "DEPTH_FACTOR": 0.34,
                "BOTTLENECK_WIDTH_FACTOR": 2.25, "NUM_CLASSES": 400,
                "DROPOUT_RATE": 0.5, "WEIGHT_DECAY": 5e-5,
                "BN": {"MOMENTUM": 0.9, "EPS": 1e-5}}


# the train cells' metrics, which the tiny train cells report (the train
# cells of BENCHMARK.json are out for now: PERF.md)
TRAIN_END_TO_END = [
    {"name": "train_clips_per_s", "unit": "clips/s", "better": "higher",
     "bound": 0.25, "source": "host_clock", "workloads": []},
    {"name": "train_peak_gb", "unit": "GB", "better": "lower", "bound": 0.01,
     "source": "device_trace", "workloads": []}]
TRAIN_PER_LAYER = [
    ("idle_share.train", "%", "lower", "device"),
    ("mfu.train", "%", "higher", "engine and train step"),
    ("dw_roofline.train", "%", "higher", "kernels"),
    ("pw_roofline.train", "%", "higher", "kernels"),
    ("nonconv_ms.train", "ms", "lower", "model"),
    ("launches.train", "count", "lower", "ops"),
    ("nccl_ms.train", "ms", "lower", "parallel")]


def _train_metrics(spec: dict) -> None:
    """Adds the train metrics that ``BENCHMARK.json`` lacks."""
    have = {m["name"] for m in spec["end_to_end"] + spec["per_layer"]}
    spec["end_to_end"][:0] = [dict(m) for m in TRAIN_END_TO_END
                              if m["name"] not in have]
    spec["per_layer"] += [
        {"name": n, "unit": u, "better": b, "source": "device_trace",
         "layer": layer, "moves": "train_clips_per_s", "workloads": []}
        for n, u, b, layer in TRAIN_PER_LAYER if n not in have]


def _write(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


@pytest.fixture
def tiny_bench(tmp_path):
    """A checkout's copy of ``BENCHMARK.json`` and ``benchmark/`` with the
    tiny cells ``tiny_train`` and ``tiny_serve`` added as new files."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    _train_metrics(spec)
    with open(os.path.join(ROOT, "benchmark", "configs", "x3d_m.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "tiny"
    cfg["config"]["NETWORK"] = dict(TINY_NETWORK)
    cfg["config"]["DATA"].update(TEMP_DURATION=4, TRAIN_CROP_SIZE=32,
                                 TEST_CROP_SIZE=32)
    cfg["config"]["TEST"].update(NUM_TEMPORAL_VIEWS=2)
    cfg["config"]["TPU"]["COMPUTE_DTYPE"] = "float32"
    b = root / "benchmark"
    _write(str(b / "configs" / "tiny.json"), cfg)
    _write(str(b / "traffic" / "tiny_train.json"),
           {"kind": "train", "clips": 4, "ranks": 1, "pool": 4,
            "ref_steps": 3, "warm": 1})
    _write(str(b / "traffic" / "tiny_dp2.json"),
           {"kind": "train", "clips": 2, "ranks": 2, "pool": 4,
            "ref_steps": 3, "warm": 1})
    _write(str(b / "traffic" / "tiny_serve.json"),
           {"kind": "serve", "videos": 2, "pool": 2})
    limits = {"loss_gap": {"limit": 1e-4}, "grad_gap": {"limit": 1e-3},
              "change_gap": {"limit": 1e-3}, "prob_gap": {"limit": 1e-4}}
    for w in ("tiny_train", "tiny_dp2", "tiny_serve"):
        _write(str(b / "limits" / f"{w}.json"), limits)
    with open(b / "metrics" / "tiny_count.py", "w") as f:
        f.write("def read(ctx):\n    return float(ctx.calls)\n")
    _write(str(b / "kernel_classes" / "tiny.json"),
           {"class": "tiny", "patterns": ["tiny_kernel"]})
    spec["configs"].append({"name": "tiny", "source": "tests",
                            "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "tests"})
    spec["workloads"] += [
        {"name": "tiny_train", "config": "tiny", "traffic": "tiny_train",
         "chips": 1, "why": "tests"},
        {"name": "tiny_dp2", "config": "tiny", "traffic": "tiny_dp2",
         "chips": 2, "why": "tests"},
        {"name": "tiny_serve", "config": "tiny", "traffic": "tiny_serve",
         "chips": 1, "why": "tests"}]
    for m in spec["end_to_end"]:
        if "workloads" in m:
            m["workloads"] += ["tiny_train", "tiny_dp2"] \
                if "train" in m["name"] else ["tiny_serve"]
    for m in spec["per_layer"]:
        if m["name"].endswith(".serve"):
            m["workloads"].append("tiny_serve")
        elif m["name"].endswith(".train"):
            m["workloads"] += ["tiny_dp2"] if m["name"] == "nccl_ms.train" \
                else ["tiny_train", "tiny_dp2"]
    spec["per_layer"].append(
        {"name": "tiny_count", "unit": "count", "better": "lower",
         "source": "device_trace", "layer": "device",
         "moves": "train_clips_per_s", "workloads": ["tiny_train"]})
    _write(str(root / "BENCHMARK.json"), spec)
    return str(root)
