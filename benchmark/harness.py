"""The benchmark of x3d_tpu_torch: one cell, one run, one result line.

``python benchmark/run.py --workload W --seed N --seconds S --trace 0|1``
from the root of a checkout.  The cell (``BENCHMARK.json``) names a
configuration and a traffic mix (``benchmark/configs``,
``benchmark/traffic``); the mix's ``kind`` picks the driver:

* ``train``: ``train/steps.make_train_step``'s step at ``clips`` clips a
  chip, on ``ranks`` processes, one a chip (more than one: NCCL, the
  config's synced BN, gradients averaged), fed from a pool of ``pool``
  distinct batches made on the device from the seed and cycled.  Set-up
  takes the first ``ref_steps`` steps one by one and records what the
  comparison reads, then times ``warm`` steps; the window runs as many
  steps as fill ``--seconds`` at that pace.
* ``serve``: ``InferenceEngine.predict`` in a closed loop, one client, on
  requests of ``videos`` videos x the config's views of uint8 clips from
  a pool of ``pool`` requests in host memory made from the seed.

The window's end-to-end metrics come from the host's clock; with
``--trace 1`` a bounded number of calls after the window is traced and
the per-layer metrics (``benchmark/metrics``) read from it.  Then the
program is freed and the float32 reference (``benchmark/reference``) is
run on the same weights and inputs, and the numbers ``compare.py`` takes
are held to the cell's limits (``benchmark/limits``).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import json
import math
import os
import socket
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import compare, host, layers, registry, trace, weights
from benchmark.reference import train as rtrain
from benchmark.reference import x3d as rx3d

FORBIDDEN = ("jax", "jaxlib", "flax", "x3d_tpu")
GB = 1e9
TRACE_DEVICE_S = 1.2        # device time a traced window should hold


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def derive(seed: int, *parts) -> int:
    """A 63-bit seed for one use of the run's seed."""
    digest = hashlib.sha256(repr((seed,) + parts).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def network(cfgfile: dict) -> dict:
    return cfgfile["config"]["NETWORK"]


def bn_momentum(cfgfile: dict) -> float:
    return rx3d.plan(network(cfgfile)).momentum


def port_config(cfgfile: dict):
    from x3d_tpu_torch.config import get_default_config

    cfg = get_default_config()
    cfg.merge_from_other_cfg(cfgfile["config"])
    return cfg


def normalise(px: torch.Tensor, data: dict) -> torch.Tensor:
    """uint8 pixels to float32 standardised per channel."""
    mean = torch.tensor(data["MEAN"], device=px.device)
    std = torch.tensor(data["STD"], device=px.device)
    return (px.to(torch.float32) / 255.0 - mean) / std


@contextlib.contextmanager
def full_float32():
    """No TF32 in float32 convs and products, for the reference."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def pixels(shape, views: int, gen: torch.Generator, device) -> torch.Tensor:
    """uint8 clips (N, T, H, W, C): each video (``views`` clips in a row)
    a colour of its own in [32, 224) with noise of its own amplitude in
    [8, 64).  (Drifting gratings of each video's own move the network's
    answers no further apart: PERF.md.)"""
    n, c = shape[0] // views, shape[-1]
    mean = torch.rand((n, 1, c), generator=gen, device=device) * 192 + 32
    amp = torch.rand((n, 1, 1), generator=gen, device=device) * 56 + 8
    noise = torch.randn(shape, generator=gen, device=device)
    noise = noise.view(n, -1, c) * amp + mean
    return noise.round_().clamp_(0, 255).to(torch.uint8).view(shape)


# ------------------------------------------------------------------ train


def train_batch(cfgfile: dict, traffic: dict, seed: int, index: int,
                rank: int, device, dtype) -> Dict[str, torch.Tensor]:
    """Pool batch ``index`` of data rank ``rank``: uint8 pixels
    (:func:`pixels`) and labels drawn on the device, standardised to the
    compute dtype."""
    c = cfgfile["config"]
    S = c["DATA"]["TRAIN_CROP_SIZE"]
    shape = (traffic["clips"], c["DATA"]["TEMP_DURATION"], S, S,
             c["DATA"]["NUM_INPUT_CHANNELS"])
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "batch", index, rank))
    px = pixels(shape, 1, gen, device)
    label = torch.randint(0, c["NETWORK"]["NUM_CLASSES"], shape[:1],
                          generator=gen, device=device)
    return {"video": normalise(px, c["DATA"]).to(dtype), "label": label}


def compute_dtype(cfgfile: dict) -> torch.dtype:
    return getattr(torch, cfgfile["config"]["TPU"]["COMPUTE_DTYPE"])


class TrainProgram:
    """The program's train step with its model, optimizer state and feed,
    built once from the seed."""

    def __init__(self, cfgfile: dict, traffic: dict, seed: int, device,
                 mesh=None):
        from x3d_tpu_torch.models import create_model
        from x3d_tpu_torch.train import create_train_state
        from x3d_tpu_torch.train import steps
        from x3d_tpu_torch.utils import use_deterministic_cudnn

        self.cfg = port_config(cfgfile)
        self.traffic, self.device = traffic, device
        rank = mesh.data_rank if mesh is not None else 0
        if device.type == "cuda":
            use_deterministic_cudnn()
        self.dtype = compute_dtype(cfgfile)
        model = create_model(self.cfg, dtype=self.dtype, device=device,
                             init=False, mesh=mesh)
        model.load_state_dict(weights.make(network(cfgfile),
                                           derive(seed, "weights"), device))
        self.model = model
        self.state = create_train_state(self.cfg, model)
        self.step_fn = steps.make_train_step(
            model, self.cfg.NETWORK.WEIGHT_DECAY)
        self.pool = [train_batch(cfgfile, traffic, seed, j, rank, device,
                                 self.dtype)
                     for j in range(traffic["pool"])]
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(derive(seed, "dropout"))
        self.done = 0

    def step(self) -> dict:
        batch = self.pool[self.done % len(self.pool)]
        self.state, metrics = self.step_fn(self.state, batch, self.gen)
        self.done += 1
        return metrics

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in
                self.model.state_dict().items()}

    def first_steps(self, n: int) -> dict:
        """Take the first ``n`` steps one by one; the record the
        comparison reads."""
        init = self.state_dict()
        losses, first_grad, first = [], {}, {}
        for i in range(n):
            losses.append(float(self.step()["loss"]))
            if i == 0:
                opt = self.state.optimizer
                first_grad = {name: opt.state[p]["momentum_buffer"].clone()
                              for name, p in self.model.named_parameters()}
                first = self.state_dict()
        return {"losses": losses, "first_grad": first_grad, "init": init,
                "first": first, "after": self.state_dict()}

    def free(self) -> None:
        del self.model, self.state, self.step_fn, self.pool
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def reference_train(cfgfile: dict, traffic: dict, seed: int, device,
                    steps: int, low: Optional[str] = None,
                    ranks: Optional[List[int]] = None,
                    half: bool = False, plant=None) -> dict:
    """The reference's first ``steps`` steps on the global batch (the
    ranks' batches in rank order).  ``low`` rounds where the configuration
    computes in bf16 (``reference/x3d.py``); ``ranks`` keeps some of the
    ranks' batches, ``half`` the first half of the rows, and ``plant(model)``
    may hook the model: the control and the faults that calibration
    plants."""
    c = cfgfile["config"]
    world = traffic.get("ranks", 1)
    ranks = list(range(world)) if ranks is None else ranks
    rows = traffic["clips"]
    dtype = compute_dtype(cfgfile)
    with full_float32():
        model = rx3d.build(network(cfgfile),
                           weights.make(network(cfgfile),
                                        derive(seed, "weights"), device),
                           device, low=low)
        if plant is not None:
            plant(model)
        init = {k: v.clone() for k, v in model.state_dict().items()}
        batches, keeps, lrs = [], [], []
        spe = max(1, c["TRAIN"]["DATASET_SIZE"] // c["TRAIN"]["BATCH_SIZE"])
        dseed = derive(seed, "dropout")
        for j in range(steps):
            parts = [train_batch(cfgfile, traffic, seed, j, r, device, dtype)
                     for r in ranks]
            keep = rtrain.dropout_keep(dseed, j, world, rows,
                                       c["NETWORK"]["DROPOUT_RATE"], device)
            keep = torch.cat([keep[r * rows:(r + 1) * rows] for r in ranks])
            batch = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
            if half:
                n = batch["label"].shape[0] // 2
                batch = {k: v[:n] for k, v in batch.items()}
                keep = keep[:n]
            batches.append(batch)
            keeps.append(keep)
            lrs.append(rtrain.lr_at(c["TRAIN"], j, spe))
        out = rtrain.run_steps(model, batches, keeps, lrs,
                               c["TRAIN"]["MOMENTUM"],
                               c["NETWORK"]["WEIGHT_DECAY"])
        out.update(init=init, after=model.state_dict())
    return out


# ------------------------------------------------------------------ serve


def serve_pool(cfgfile: dict, traffic: dict, seed: int, device
               ) -> List[np.ndarray]:
    """The requests, in host memory: uint8 clips drawn on the device
    (:func:`pixels`)."""
    c = cfgfile["config"]
    S = c["DATA"]["TEST_CROP_SIZE"]
    views = c["TEST"]["NUM_TEMPORAL_VIEWS"] * c["TEST"]["NUM_SPATIAL_CROPS"]
    shape = (traffic["videos"] * views, c["DATA"]["TEMP_DURATION"], S, S,
             c["DATA"]["NUM_INPUT_CHANNELS"])
    out = []
    for j in range(traffic["pool"]):
        gen = torch.Generator(device=device)
        gen.manual_seed(derive(seed, "request", j))
        out.append(pixels(shape, views, gen, device).cpu().numpy())
    return out


class ServeProgram:
    def __init__(self, cfgfile: dict, traffic: dict, seed: int, device):
        from x3d_tpu_torch.models import create_model
        from x3d_tpu_torch.serving import InferenceEngine

        cfg = port_config(cfgfile)
        self.device = device
        dtype = compute_dtype(cfgfile) if device.type == "cuda" \
            else torch.float32
        model = create_model(cfg, dtype=dtype, device=device, init=False)
        model.load_state_dict(weights.make(network(cfgfile),
                                           derive(seed, "weights"), device))
        self.engine = InferenceEngine(cfg, model,
                                      max_videos=traffic["videos"],
                                      dtype=dtype, device=device)
        self.pool = serve_pool(cfgfile, traffic, seed, device)
        self.done = 0

    def call(self) -> np.ndarray:
        out = self.engine.predict(self.pool[self.done % len(self.pool)])
        self.done += 1
        return out

    def free(self) -> None:
        del self.engine
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def reference_serve(cfgfile: dict, seed: int, pool: List[np.ndarray],
                    device, low: Optional[str] = None) -> List[np.ndarray]:
    """The reference's view-averaged probabilities of each request."""
    c = cfgfile["config"]
    views = c["TEST"]["NUM_TEMPORAL_VIEWS"] * c["TEST"]["NUM_SPATIAL_CROPS"]
    with full_float32():
        model = rx3d.build(network(cfgfile),
                           weights.make(network(cfgfile),
                                        derive(seed, "weights"), device),
                           device, low=low).eval()
        out = []
        for clips in pool:
            video = normalise(torch.from_numpy(clips).to(device), c["DATA"])
            out.append(model.probabilities(video, views).cpu().numpy())
    return out


# ------------------------------------------------------------------ a run


class Run:
    """One run of a cell on one rank."""

    def __init__(self, bench: registry.Bench, workload: str, seed: int,
                 seconds: float, traced: bool, device, t_start: float,
                 rank: int = 0, world: int = 1, port: int = 0):
        self.bench, self.seed, self.seconds = bench, seed, seconds
        self.traced, self.device, self.t_start = traced, device, t_start
        self.cell = bench.workload(workload)
        self.cfgfile = bench.config(self.cell["config"])
        self.traffic = bench.traffic(self.cell["traffic"])
        self.rank, self.world, self.port = rank, world, port
        self.kind = self.traffic["kind"]
        self.out: dict = {}
        self.phases: Dict[str, float] = {}

    # the window's clock
    def _timed(self, call, until=None, count=None) -> tuple:
        sync(self.device)
        t0 = time.perf_counter()
        self.out["setup_s"] = t0 - self.t_start
        watch = host.Watch()
        times, results = [], []
        while True:
            a = time.perf_counter()
            results.append(call())
            times.append(time.perf_counter() - a)
            if count is not None and len(times) >= count:
                break
            if until is not None and time.perf_counter() - t0 >= until:
                break
        sync(self.device)
        elapsed = time.perf_counter() - t0
        self.out["host"] = watch.report()
        return elapsed, times, results

    def after_window(self, call, calls: int, span: str, clips: int,
                     size: int) -> None:
        """With ``--trace 1``, trace ``calls`` more calls and read the
        per-layer metrics; then the memory peak."""
        if self.traced:
            window = trace.profile_calls(call, calls)
            window.span = span
            window.classes = self.bench.kernel_classes()
            ctx = layers.Context(self.kind, window, network(self.cfgfile),
                                 clips, self.cfgfile["config"]["DATA"]
                                 ["TEMP_DURATION"], size)
            readings = {m["name"]: self.bench.reader(m["name"])(ctx)
                        for m in self.bench.per_layer(self.cell["name"])}
            self.out.update(per_layer={k: v for k, v in readings.items()
                                       if v is not None},
                            busy_s=window.busy_s, window_s=window.window_s,
                            breakdown=window.breakdown())
        self.out["peak"] = torch.cuda.max_memory_allocated(self.device) \
            if self.device.type == "cuda" else 0

    def mark(self, phase: str) -> None:
        """Note the seconds since the start at the end of a set-up
        phase (printed on stderr)."""
        sync(self.device)
        self.phases[phase] = time.perf_counter() - self.t_start

    def run_train(self, mesh=None) -> dict:
        t = self.traffic
        self.mark("imports")
        prog = TrainProgram(self.cfgfile, t, self.seed, self.device, mesh)
        self.mark("model, weights, pool")
        record = prog.first_steps(t.get("ref_steps", 3))
        self.mark("first steps")
        a = time.perf_counter()
        for _ in range(t["warm"]):
            prog.step()
        sync(self.device)
        pace = (time.perf_counter() - a) / t["warm"]
        n = torch.tensor([max(1, round(self.seconds / pace))])
        if mesh is not None and mesh.distributed:
            import torch.distributed as dist
            n = n.to(self.device)
            dist.broadcast(n, 0)
        elapsed, _, _ = self._timed(prog.step, count=int(n))
        clips = t["clips"] * self.world
        self.out.update(attempted=int(n), failed=0,
                        train_clips_per_s=int(n) * clips / elapsed)
        self.after_window(prog.step, max(3, math.ceil(TRACE_DEVICE_S / pace)),
                          "train_step", t["clips"],
                          self.cfgfile["config"]["DATA"]["TRAIN_CROP_SIZE"])
        self.out["train_peak_gb"] = self.out["peak"] / GB
        prog.free()
        return record

    def run_serve(self) -> dict:
        t = self.traffic
        self.mark("imports")
        prog = ServeProgram(self.cfgfile, t, self.seed, self.device)
        self.mark("model, weights, pool")
        for _ in range(len(prog.pool)):            # every request warm
            prog.call()
        self.mark("first requests")
        prog.done = 0
        elapsed, times, answers = self._timed(prog.call, until=self.seconds)
        clips = answers[0].shape[0] * prog.engine.views
        failed = sum(1 for a in answers if not np.isfinite(a).all())
        self.out.update(attempted=len(answers), failed=failed,
                        serve_clips_per_s=len(answers) * clips / elapsed,
                        serve_p95_ms=1e3 * float(np.percentile(times, 95)))
        self.after_window(
            prog.call, max(5, math.ceil(TRACE_DEVICE_S * len(times)
                                        / elapsed)),
            "predict", clips, self.cfgfile["config"]["DATA"]["TEST_CROP_SIZE"])
        pool = prog.pool
        prog.free()
        return {"answers": answers, "pool": pool}

    def check(self, record: dict) -> Dict[str, float]:
        """The comparison's numbers, from the reference run after the
        program is freed."""
        if self.kind == "train":
            ref = reference_train(self.cfgfile, self.traffic, self.seed,
                                  self.device, len(record["losses"]))
            return compare.train_numbers(record, ref,
                                         bn_momentum(self.cfgfile))
        ref = reference_serve(self.cfgfile, self.seed, record["pool"],
                              self.device)
        return compare.serve_numbers(record["answers"], ref)


# ------------------------------------------------------------------ ranks


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mesh(run: Run):
    from x3d_tpu_torch import parallel

    return parallel.init_mesh(
        rank=run.rank, world_size=run.world, local_rank=run.rank,
        init_method=f"tcp://localhost:{run.port}",
        device=None if run.device.type == "cuda" else run.device)


def _device(kind: str, rank: int) -> torch.device:
    return torch.device("cuda", rank) if kind == "cuda" \
        else torch.device(kind)


def rank_main(root: str, args: dict, rank: int, world: int, port: int,
              kind: str) -> None:
    """A data rank above 0: its share of the run; rank 0 gathers."""
    import torch.distributed as dist

    device = _device(kind, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    run = Run(registry.Bench(root), args["workload"], args["seed"],
              args["seconds"], args["trace"], device, time.perf_counter(),
              rank, world, port)
    run.run_train(_mesh(run))
    dist.all_gather_object([None] * world, run.out)
    dist.destroy_process_group()


def drive(bench: registry.Bench, args: dict, device: torch.device,
          t_start: float) -> tuple:
    """Run the cell: one process, or one a rank (rank 0 this one, the
    others spawned and waited for).  Returns the run, each rank's
    readings and the record the comparison reads."""
    cell = bench.workload(args["workload"])
    world = bench.traffic(cell["traffic"]).get("ranks", 1)
    port = free_port() if world > 1 else 0
    run = Run(bench, args["workload"], args["seed"], args["seconds"],
              bool(args["trace"]), device, t_start, 0, world, port)
    if run.kind == "serve":
        record = run.run_serve()
        return run, [run.out], record
    if world == 1:
        record = run.run_train()
        return run, [run.out], record
    import multiprocessing

    import torch.distributed as dist

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main,
                         args=(bench.root, args, r, world, port,
                               device.type))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        record = run.run_train(_mesh(run))
        outs = [None] * world
        dist.all_gather_object(outs, run.out)
        dist.destroy_process_group()
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"a rank failed: exit codes {codes}")
    return run, outs, record


def result_line(run: Run, outs: List[dict], checks: Dict[str, dict],
                correct: bool) -> dict:
    bench, name = run.bench, run.cell["name"]
    first = outs[0]
    if run.traced:
        metrics = {}
        for m in bench.per_layer(name):
            vals = [o["per_layer"][m["name"]] for o in outs
                    if m["name"] in o.get("per_layer", {})]
            if len(vals) == len(outs):
                metrics[m["name"]] = {"value": sum(vals) / len(vals),
                                      "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": max(o[m["name"]] for o in outs)
                               if m["name"] == "train_peak_gb"
                               else first[m["name"]], "unit": m["unit"]}
                   for m in bench.end_to_end(name)}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": run.world,
              "memory_peak_bytes": max(o["peak"] for o in outs)}
    line = {"correct": correct, "attempted": first["attempted"],
            "failed": first["failed"], "metrics": metrics, "device": device}
    if run.traced:
        device["busy_s"] = sum(o["busy_s"] for o in outs) / len(outs)
        device["window_s"] = sum(o["window_s"] for o in outs) / len(outs)
        line["breakdown"] = first["breakdown"]
    line["checks"] = checks
    return line


def main(argv: List[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.path.dirname(registry.HERE)
    bench = registry.Bench(root)
    cell = bench.workload(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from x3d_tpu_torch.kernels import _build
    _build.build_all()
    limits = bench.limits(args.workload)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run, outs, record = drive(bench, vars(args), device, t_start)
    numbers = run.check(record)
    checks = compare.judge(numbers, limits)
    correct = compare.passed(checks) and outs[0]["failed"] == 0
    found = forbidden_modules()
    if found:
        print(f"modules of the JAX package or JAX loaded: {found}",
              file=sys.stderr)
        return 1
    print("set-up, seconds from the start at the end of each phase: "
          + json.dumps(run.phases), file=sys.stderr)
    print("the host during the window: " + json.dumps(outs[0]["host"]),
          file=sys.stderr)
    for k, c in checks.items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result_line(run, outs, checks, correct)))
    return 0
