"""A run with its timed path broken underneath comes out not correct,
under the limits of the cells on the card; so does the control.  The
faults: a step that leaves the state unchanged, half the batch, the
exchange between ranks left out; an answer altered, answers given to the
wrong videos.

The harness's look for a card is skipped (the run is driven on the CPU at
a tiny size); the rest of a run is the harness's own: set-up, the window,
the reference after it, the comparison against the limits.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest
import torch

from benchmark import compare, harness, registry
from benchmark.tests.conftest import ROOT


def _limits(tiny_bench, cell):
    with open(os.path.join(ROOT, "benchmark", "limits", f"{cell}.json")) as f:
        limits = json.load(f)
    w = "tiny_train" if "train" in cell else "tiny_serve"
    with open(os.path.join(tiny_bench, "benchmark", "limits", f"{w}.json"),
              "w") as f:
        json.dump(limits, f)
    return w


def _correct(tiny_bench, workload):
    run = harness.Run(registry.Bench(tiny_bench), workload, 2**31 + 77, 0.3,
                      False, torch.device("cpu"), time.perf_counter())
    record = run.run_train() if run.kind == "train" else run.run_serve()
    checks = compare.judge(run.check(record),
                           run.bench.limits(workload))
    return compare.passed(checks), checks


def _unchanged(real):
    def make(model, wd):
        step = real(model, wd)

        def broken(state, batch, gen):
            keep = {k: v.clone() for k, v in model.state_dict().items()}
            state, metrics = step(state, batch, gen)
            model.load_state_dict(keep)
            return state, metrics
        return broken
    return make


def _half_batch(real):
    def make(model, wd):
        step = real(model, wd)

        def broken(state, batch, gen):
            n = batch["label"].shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()}, gen)
        return broken
    return make


@pytest.mark.parametrize("cell", ["m_train_b32", "l_train_b16"])
def test_train_faults_are_caught(tiny_bench, monkeypatch, cell):
    from x3d_tpu_torch.train import steps

    w = _limits(tiny_bench, cell)
    ok, checks = _correct(tiny_bench, w)
    assert ok, checks
    real = steps.make_train_step
    for fault in (_unchanged, _half_batch):
        monkeypatch.setattr(steps, "make_train_step", fault(real))
        ok, checks = _correct(tiny_bench, w)
        assert not ok, (fault.__name__, checks)


def _altered(out):
    out[0] = np.roll(out[0], 1)              # one video's answer altered
    return out


def _swapped(out):
    return out[::-1].copy()                  # answers to the wrong videos


@pytest.mark.parametrize("fault", [_altered, _swapped])
def test_serve_fault_is_caught(tiny_bench, monkeypatch, fault):
    from x3d_tpu_torch.serving import InferenceEngine

    w = _limits(tiny_bench, "m_serve_v8")
    ok, checks = _correct(tiny_bench, w)
    assert ok, checks
    real = InferenceEngine.predict
    monkeypatch.setattr(InferenceEngine, "predict",
                        lambda self, clips: fault(real(self, clips)))
    ok, checks = _correct(tiny_bench, w)
    assert not ok, checks


@pytest.mark.parametrize("cell", ["m_train_b32", "m_serve_v8"])
def test_the_control_is_not_correct(tiny_bench, cell):
    """The reference in float8 e4m3 in the program's place fails the
    cell's limits at a size a test run holds (on the card: PERF.md)."""
    w = _limits(tiny_bench, cell)
    bench = registry.Bench(tiny_bench)
    cfgfile = bench.config("tiny")
    traffic = bench.traffic(w)
    cpu = torch.device("cpu")
    if traffic["kind"] == "train":
        ref = harness.reference_train(cfgfile, traffic, 5, cpu, 3)
        got = harness.reference_train(cfgfile, traffic, 5, cpu, 3,
                                      low="fp8")
        numbers = compare.train_numbers(got, ref,
                                        harness.bn_momentum(cfgfile))
    else:
        pool = harness.serve_pool(cfgfile, traffic, 5, cpu)
        ref = harness.reference_serve(cfgfile, 5, pool, cpu)
        got = harness.reference_serve(cfgfile, 5, pool, cpu, low="fp8")
        numbers = compare.serve_numbers(got, ref)
    assert not compare.passed(compare.judge(numbers, bench.limits(w))), \
        numbers


DP_RUN = """
import sys, time
sys.path.insert(0, {root!r})
import torch
from benchmark import compare, harness, registry
bench = registry.Bench({bench!r})
args = dict(workload="tiny_dp2", seed=2**31 + 3, seconds=0.3, trace=0)
run, outs, record = harness.drive(bench, args, torch.device("cpu"),
                                  time.perf_counter())
checks = compare.judge(run.check(record), bench.limits("tiny_dp2"))
print(compare.passed(checks), outs[0]["attempted"], len(outs))
"""

# planted in every rank's interpreter at its start: the exchange between
# ranks left out (no gradient mean, no synced BN moments)
NO_EXCHANGE = """
import x3d_tpu_torch.parallel as p
from x3d_tpu_torch.parallel import mesh
p.all_reduce_mean_ = mesh.all_reduce_mean_ = lambda tensors, group, n: None
mesh.all_reduce_sum = lambda x, group: x
"""


@pytest.mark.parametrize("planted", [False, True])
def test_two_ranks_and_the_exchange_left_out(tiny_bench, tmp_path, planted):
    """Two gloo ranks against the reference's step on the global batch;
    with the exchange left out the run is not correct."""
    import subprocess
    import sys

    _limits(tiny_bench, "m_train_b32")
    with open(os.path.join(tiny_bench, "benchmark", "limits",
                           "tiny_train.json")) as f:
        limits = f.read()
    with open(os.path.join(tiny_bench, "benchmark", "limits",
                           "tiny_dp2.json"), "w") as f:
        f.write(limits)
    env = dict(os.environ, PYTHONPATH=ROOT)
    if planted:
        (tmp_path / "sitecustomize.py").write_text(NO_EXCHANGE)
        env["PYTHONPATH"] = f"{tmp_path}{os.pathsep}{ROOT}"
    out = subprocess.run(
        [sys.executable, "-c", DP_RUN.format(root=ROOT, bench=tiny_bench)],
        capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    ok, attempted, ranks = out.stdout.split()[-3:]
    assert ranks == "2" and int(attempted) >= 1
    assert ok == str(not planted)
