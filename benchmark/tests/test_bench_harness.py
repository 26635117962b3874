"""The harness on the CPU at a tiny size: a run's comparison, the faults
it has to catch, the cells and metrics it finds by name."""

from __future__ import annotations

import time

import torch

from benchmark import compare, harness, registry


def _run(root, workload):
    bench = registry.Bench(root)
    return harness.Run(bench, workload, seed=2**31 + 12345, seconds=0.5,
                       traced=False, device=torch.device("cpu"),
                       t_start=time.perf_counter())


def _correct(run, record):
    checks = compare.judge(run.check(record), run.bench.limits(
        run.cell["name"]))
    return compare.passed(checks), checks


def test_train_run_is_correct(tiny_bench):
    run = _run(tiny_bench, "tiny_train")
    record = run.run_train()
    ok, checks = _correct(run, record)
    assert ok, checks
    held = {k for k, c in checks.items() if c["limit"] is not None}
    assert held == {"loss_gap", "grad_gap", "change_gap"}
    assert {"stats_gap", "stats_gap_worst", "grad_gap_worst",
            "change_gap_worst", "loss_gap_worst"} <= set(checks)
    assert run.out["attempted"] >= 1 and run.out["train_clips_per_s"] > 0


def test_serve_run_is_correct(tiny_bench):
    run = _run(tiny_bench, "tiny_serve")
    record = run.run_serve()
    ok, checks = _correct(run, record)
    assert ok, checks
    assert run.out["attempted"] == len(record["answers"]) >= 1
