"""What a run finds by name, what it prints, what it refuses to load."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness, layers, registry, trace
from benchmark.tests.conftest import ROOT

FORBIDDEN_RUN = """
import sys, time
sys.path.insert(0, {root!r})
import torch
from benchmark import harness, registry
run = harness.Run(registry.Bench({bench!r}), "tiny_train", 5, 0.2, False,
                  torch.device("cpu"), time.perf_counter())
run.check(run.run_train())
print(harness.forbidden_modules())
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_a_cpu_run_loads_neither_jax_nor_the_jax_package(tiny_bench):
    out = subprocess.run(
        [sys.executable, "-c", FORBIDDEN_RUN.format(root=ROOT,
                                                    bench=tiny_bench)],
        capture_output=True, text=True, timeout=600, check=True,
        env={**os.environ, "PYTHONPATH": ""})
    found, loaded = out.stdout.strip().splitlines()[-2:]
    assert found == "[]"
    assert "x3d_tpu_torch" in loaded and "'x3d_tpu'" not in loaded


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "x3d_tpu_torch_like", sys)
    assert "x3d_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "x3d_tpu.models", sys)
    assert harness.forbidden_modules() == ["x3d_tpu"]


def test_new_files_are_found_by_name(tiny_bench):
    bench = registry.Bench(tiny_bench)
    assert bench.config("tiny")["config"]["DATA"]["TRAIN_CROP_SIZE"] == 32
    assert bench.traffic("tiny_serve")["videos"] == 2
    assert bench.limits("tiny_train")["loss_gap"]["limit"] == 1e-4
    names = [m["name"] for m in bench.per_layer("tiny_train")]
    assert "tiny_count" in names and "idle_share.train" in names
    assert "idle_share.serve" not in names
    assert [m["name"] for m in bench.end_to_end("tiny_serve")] == [
        "serve_clips_per_s", "serve_p95_ms", "setup_s"]
    classes = bench.kernel_classes()
    assert classes["tiny"] == ["tiny_kernel"]
    assert registry.classify("void tiny_kernel<4>()", classes) == ("tiny",)
    ctx = layers.Context("train", _window(), {}, 1, 1, 1)
    assert bench.reader("tiny_count")(ctx) == 2.0


def test_the_port_kernels_fall_in_their_classes():
    """One class each, but the second pass that K2 and K5/K6 share: its
    time counts in both rooflines' kernel time."""
    classes = registry.Bench(ROOT).kernel_classes()
    cases = {
        "dw_conv3d_fwd_ring_kernel<3>": ("dw",),
        "dw_bn_act_conv_bwd_ring_kernel(...)": ("dw",),
        "sum_partials_kernel(float const*, float const*, float const*, "
        "float*, float*, float*, int, int, int)": ("dw",),
        "sum_dk_partials_kernel(float const*, float*, int, int)": ("dw",),
        "pw_conv_wg_kernel<128>": ("pw",),
        "pw_act_conv_stats_mma_kernel": ("pw",),
        "sum_partials_kernel(float const*, float const*, float*, float*, "
        "int, int, int)": ("dw", "pw"),
        "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage"
        "<4096ul>)": ("nccl",),
        "Memcpy HtoD (Pageable -> Device)": ("h2d",),
        "void at::native::vectorized_elementwise_kernel<4, ...>": ()}
    for name, cls in cases.items():
        assert registry.classify(name, classes) == cls, name


def test_a_traffic_key_no_driver_reads_is_refused(tiny_bench):
    path = os.path.join(tiny_bench, "benchmark", "traffic", "tiny_open.json")
    with open(path, "w") as f:
        json.dump({"kind": "serve", "videos": 1, "pool": 2, "loop": "open"},
                  f)
    with pytest.raises(ValueError, match="loop"):
        registry.Bench(tiny_bench).traffic("tiny_open")


def test_a_kernel_of_two_classes_counts_in_both():
    ops = [trace.Op("shared_kernel", 0.0, 1.0, 0),
           trace.Op("x_kernel", 1.0, 1.5, 0),
           trace.Op("other_kernel", 1.5, 2.0, 0)]
    w = trace.Window(ops, 1, 0.0, 2.0,
                     classes={"x": ["x_", "shared_"], "y": ["shared_"]})
    assert w.seconds_by_class() == {"x": 1.5, "y": 1.0, None: 0.5}


def _window():
    ops = [trace.Op("a_kernel", 0.0, 1.0, 0),
           trace.Op("b_kernel", 0.5, 2.0, 0),      # overlaps a
           trace.Op("a_kernel", 3.0, 4.0, 1),
           trace.Op("c_kernel", 4.5, 5.0, 1)]
    return trace.Window(ops, 2, 0.0, 6.0, span="train_step",
                        classes={"x": ["b_"]})


def test_window_reduction():
    w = _window()
    assert w.busy_s == 3.5 and w.window_s == 6.0
    assert w.seconds_by_class() == {"x": 1.5, None: 2.5}
    b = w.breakdown()
    assert b["idle_gaps"] == [["between calls", 2.0],
                              ["train_step: before c_kernel", 0.5]]
    assert b["device_ops"][0] == ["a_kernel", 2.0]
    ctx = layers.Context("train", w, {}, 1, 1, 1)
    assert layers.idle_share(ctx) == pytest.approx(100 * 2.5 / 6)
    assert layers.launches(ctx) == 2.0
    assert layers.ms_per_call(ctx, None) == 1250.0


def test_result_line_keys(tiny_bench, monkeypatch):
    run = harness.Run(registry.Bench(tiny_bench), "tiny_train", 1, 1.0,
                      True, torch.device("cpu"), time.perf_counter())
    out = {"attempted": 3, "failed": 0, "peak": 10, "setup_s": 1.0,
           "train_clips_per_s": 2.0, "train_peak_gb": 1e-8,
           "per_layer": {"tiny_count": 3.0}, "busy_s": 0.5, "window_s": 1.0,
           "breakdown": {"device_ops": [], "idle_gaps": []}}
    checks = {"loss_gap": {"value": 0.0, "limit": 1e-4}}
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "none")
    line = harness.result_line(run, [out], checks, True)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert line["metrics"] == {"tiny_count": {"value": 3.0,
                                              "unit": "count"}}
    assert {"platform", "kind", "count", "memory_peak_bytes", "busy_s",
            "window_s"} <= set(line["device"])
    json.dumps(line)


def test_no_card_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no card")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
         "--workload", "m_train_b32", "--seed", str(2**31 + 9),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_a_traced_run_reads_every_metric_of_its_cell(tiny_bench,
                                                     monkeypatch):
    """The traced branch on the CPU, the profiler's window faked: every
    per-layer metric of the cell is read, none above 100%."""
    def window(call, n):
        call()
        ops = [trace.Op("dw_bn_act_conv_fwd_ring_kernel", 0.0, 0.4, 0),
               trace.Op("pw_conv_wg_kernel<96, 2>", 0.5, 0.9, 0),
               trace.Op("vectorized_elementwise_kernel", 1.0, 1.5, 0)]
        return trace.Window(ops, 1, 0.0, 2.0)

    monkeypatch.setattr(trace, "profile_calls", window)
    run = harness.Run(registry.Bench(tiny_bench), "tiny_train", 3, 0.2,
                      True, torch.device("cpu"), time.perf_counter())
    run.run_train()
    got = run.out["per_layer"]
    assert set(got) == {"idle_share.train", "mfu.train", "dw_roofline.train",
                        "pw_roofline.train", "nonconv_ms.train",
                        "launches.train", "tiny_count"}
    assert got["idle_share.train"] == pytest.approx(35.0)
    assert got["nonconv_ms.train"] == pytest.approx(500.0)
    assert all(0 < got[k] <= 100 for k in got if "roofline" in k or
               "mfu" in k)
    assert run.out["window_s"] == 2.0 and run.out["busy_s"] == 1.3
