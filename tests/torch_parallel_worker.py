"""One rank of a gloo process group on the CPU, for
``tests/test_torch_parallel.py``.  Imports the port and nothing of JAX.

    python tests/torch_parallel_worker.py SPEC.json RANK

SPEC holds the mesh (``world``, ``data``, ``model``, ``sync_bn``), the
rendezvous (``init``: a ``file://`` path), the ``mode``, the train step's
``remat`` (optional; None: the config's) and the paths of its inputs and
outputs:

* ``step``: load the tiny model's weights and batches (``inputs``, a
  ``torch.save`` file), evaluate the rank's share of the eval batch, then
  re-estimate the BN statistics on its share of the train batch (precise
  BN, one batch) in a copy, take one train step on its share of the train
  batch inside the window of the loop's ``ProfileHook`` (a stand-in for
  the device profiler: the CPU has no device trace); save a checkpoint
  and restore it into a fresh model; write the loss, the eval sums, the
  step's spans and the span names of the hook's summary, every gradient,
  the updated state and optimizer slots (the head's shards joined into
  full tensors) and whether the restore gave back the live state to
  ``out/rank<R>.pt``.
* ``tool``: run ``tools.train.main(argv)`` as torchrun's rank R would,
  then ``tools.eval.main(eval_argv)`` where given; write each logged
  step's loss, the final state, the checkpoint files the rank wrote and
  what eval printed.
"""

import contextlib
import io
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


class _Block:
    """Keep tensorboard out: the train tool's hook then stays inactive
    (importing it takes seconds)."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "tensorboard":
            raise ImportError(f"blocked: {name}")
        return None


def tiny_cfg(sync_bn=True, views=2, batch=4):
    """``tests/test_torch_train.py``'s tiny XS geometry, with ``views``
    eval views a video."""
    from x3d_tpu_torch import variant_config

    cfg = variant_config("XS")
    cfg.NETWORK.C1_CHANNELS = 4
    cfg.NETWORK.DEPTH_FACTOR = 0.34
    cfg.NETWORK.NUM_CLASSES = 10
    cfg.NETWORK.DROPOUT_RATE = 0.0
    cfg.DATA.TEMP_DURATION = 4
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 32
    cfg.TEST.NUM_TEMPORAL_VIEWS = views
    cfg.TEST.NUM_SPATIAL_CROPS = 1
    cfg.TRAIN.DATASET_SIZE = 8
    cfg.TRAIN.BATCH_SIZE = batch
    cfg.TPU.SYNC_BN = sync_bn
    return cfg


class _CpuProfiler:
    """A stand-in for ``tools/trace.device_profiler`` on the CPU: one
    device operation at the window's start, its events' timeline from
    the host time the window started."""

    def start(self):
        import time

        self.t0 = time.time_ns()

    def stop(self):
        pass

    def events(self):
        import types

        from torch.autograd import DeviceType
        from torch.autograd.profiler_util import Interval

        return [types.SimpleNamespace(name="op", device_type=DeviceType.CUDA,
                                      time_range=Interval(0, 10))]

    @property
    def profiler(self):
        import types

        return types.SimpleNamespace(kineto_results=types.SimpleNamespace(
            trace_start_ns=lambda: self.t0))

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": []}, f)


@contextlib.contextmanager
def _cpu_profiler():
    """Within this context the profile hook's device profiler is
    :class:`_CpuProfiler` and synchronising the card does nothing."""
    import torch

    from x3d_tpu_torch.tools import trace

    prev = trace.device_profiler, torch.cuda.synchronize
    trace.device_profiler = _CpuProfiler
    torch.cuda.synchronize = lambda: None
    try:
        yield
    finally:
        trace.device_profiler, torch.cuda.synchronize = prev


def _step(spec, rank):
    import datetime

    import torch

    from x3d_tpu_torch import parallel
    from x3d_tpu_torch.models import create_model
    from x3d_tpu_torch.parallel import mesh as pmesh
    from x3d_tpu_torch.train import (create_train_state, make_bn_recalibrator,
                                     make_eval_step, make_train_step)
    from x3d_tpu_torch.train.checkpoint import CheckpointManager
    from x3d_tpu_torch.train.hooks import ProfileHook
    from x3d_tpu_torch.train.loop import evaluate

    mesh = parallel.init_mesh(
        spec["data"], spec["model"], rank=rank, world_size=spec["world"],
        init_method=spec["init"], device="cpu",
        timeout=datetime.timedelta(seconds=120))
    inputs = torch.load(spec["inputs"], weights_only=True)
    dtype = getattr(torch, spec.get("dtype", "float32"))
    cfg = tiny_cfg(spec["sync_bn"], inputs["views"], len(inputs["label"]))
    model = create_model(cfg, dtype=dtype, device="cpu", init=False,
                         mesh=mesh, remat=spec.get("remat"))
    model.load_state_dict(inputs["state"])
    state = create_train_state(cfg, model)

    ebatch = parallel.shard_batch(
        {"video": inputs["eval_video"], "label": inputs["eval_label"]},
        mesh, clips_per_sample=inputs["views"])
    sums = evaluate(make_eval_step(model), state, [ebatch])

    batch = parallel.shard_batch(
        {"video": inputs["video"], "label": inputs["label"]}, mesh)

    # precise BN on the rank's share of the batch, from the loaded state
    recal = create_model(cfg, dtype=dtype, device="cpu", init=False,
                         mesh=mesh)
    recal.load_state_dict(inputs["state"])
    make_bn_recalibrator(recal, lambda: [batch], 1, 0,
                         cfg.NETWORK.BN.MOMENTUM)(
        create_train_state(cfg, recal))
    recal_stats = {k: v for k, v in recal.state_dict().items()
                   if k.endswith((".mean", ".var"))}

    step = make_train_step(model, cfg.NETWORK.WEIGHT_DECAY)
    where = os.path.join(spec["out"], f"profile{rank}")
    hook = ProfileHook(where, 1)
    with _cpu_profiler():
        hook.on_step(0, {})
        state, metrics = step(state, batch, torch.Generator().manual_seed(0))
        hook.on_step(1, {})
    with open(os.path.join(where, "profile_step1_spans.json")) as f:
        spans = json.load(f)
    with open(os.path.join(where, "profile_step1_summary.json")) as f:
        profiled = json.load(f)
    grads = {n: p.grad.detach() for n, p in model.named_parameters()}
    for n, dim in model.head_split.items():
        grads[n] = pmesh.gather_split(grads[n], dim, mesh)
    out = {"loss": float(metrics["loss"]),
           "metrics": {k: float(v) for k, v in metrics.items()},
           "eval": sums, "grads": grads,
           "state": parallel.full_model_state(model),
           "optimizer": parallel.full_optimizer_state(state.optimizer,
                                                      model),
           "recal": recal_stats,
           "mesh": [mesh.data_rank, mesh.model_rank], "step": state.step,
           "spans": [[r["name"], r["parent"] is None] for r in spans],
           "span_host": sorted(profiled["span_host_ms_per_step"]),
           "out_dir": spec["out"]}

    # a checkpoint of the state after the step (rank 0 writes it), restored
    # into a fresh model on every rank: the same shards, slots and step
    mgr = CheckpointManager(os.path.join(spec["out"], "checkpoints"))
    mgr.save(1, state)
    fresh = create_model(cfg, dtype=dtype, device="cpu", init=False,
                         mesh=mesh)
    restored, _ = mgr.restore(create_train_state(cfg, fresh))
    live = state.optimizer.state_dict()["state"]
    again = restored.optimizer.state_dict()["state"]
    out["restored_equal"] = (
        restored.step == state.step
        and all(torch.equal(t, model.state_dict()[k])
                for k, t in fresh.state_dict().items())
        and sorted(live) == sorted(again)
        and all(torch.equal(again[i][k], v) for i, slots in live.items()
                for k, v in slots.items()))
    parallel.barrier(mesh)
    torch.save(out, os.path.join(spec["out"], f"rank{rank}.pt"))
    parallel.shutdown()


def _tool(spec, rank):
    import torch

    from x3d_tpu_torch.tools import train as train_cli
    from x3d_tpu_torch.train import checkpoint
    from x3d_tpu_torch.train.hooks import Hook

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(spec["world"]))
    writes = []
    save = checkpoint.torch.save

    def counting_save(obj, path, *a, **k):
        writes.append(os.path.basename(str(path)))
        return save(obj, path, *a, **k)

    checkpoint.torch.save = counting_save
    losses = []

    class Keep(Hook):
        def on_step(self, step, metrics):
            losses.append((step, metrics["loss"]))

        def on_epoch_end(self, epoch, state, train_metrics, val_metrics):
            self.state = state

    keep = Keep()
    try:
        rc = train_cli.main([f"--init_method={spec['init']}"]
                            + spec["argv"], extra_hooks=[keep])
    finally:
        checkpoint.torch.save = save
    printed = io.StringIO()
    if spec.get("eval_argv"):
        from x3d_tpu_torch.tools import eval as eval_cli

        with contextlib.redirect_stdout(printed):
            eval_cli.main([f"--init_method={spec['init']}"]
                          + spec["eval_argv"])
    torch.save({"rc": rc, "losses": losses, "writes": writes,
                "eval_stdout": printed.getvalue(),
                "step": keep.state.step,
                "state": keep.state.model.state_dict(),
                "optimizer": keep.state.optimizer.state_dict()},
               os.path.join(spec["out"], f"rank{rank}.pt"))
    from x3d_tpu_torch import parallel
    parallel.shutdown()


def main():
    sys.meta_path.insert(0, _Block())
    import torch

    torch.set_num_threads(1)
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    rank = int(sys.argv[2])
    {"step": _step, "tool": _tool}[spec["mode"]](spec, rank)


if __name__ == "__main__":
    main()
