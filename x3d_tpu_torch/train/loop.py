"""The training / evaluation loops.

The counterpart of the JAX package's ``x3d_tpu/train/loop.py``: epochs of
``steps_per_epoch`` steps, per-epoch validation, hook dispatch, and honest
metric aggregation (exact sums, not batch-mean-of-means).  Metrics stay on
the device: ``evaluate`` adds the per-batch sums there and fetches once,
``fit`` fetches the train metrics only at ``metrics_every`` (a fetch
synchronises the host with the card).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Iterator, Optional, Sequence

import torch

from x3d_tpu_torch.train.hooks import Hook
from x3d_tpu_torch.train.schedule import lr_for_epoch

log = logging.getLogger(__name__)


def _to_host(metrics) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


def evaluate(eval_step: Callable, state, batches: Iterable[dict],
             profile_batch: int = 0,
             profile_dir: Optional[str] = None) -> Dict[str, float]:
    """Aggregate eval sums over a dataset -> {'loss','acc','top_5_acc',
    'count'}.

    The per-batch metric sums stay on the device and are added there; the
    host fetches exactly once, after the last batch.

    ``profile_batch``/``profile_dir``: capture a ``torch.profiler`` device
    trace around batch N (1-based) into ``profile_dir``; the profiled batch
    is synchronised so its device work lands inside the trace.

    On a mesh of processes (the model's ``mesh``) each data rank sums its
    own batches and the four sums are all-reduced over the data group once,
    after the last batch: ranks may hold unequal numbers of batches, so no
    collective runs per batch.
    """
    totals = None
    for i, batch in enumerate(batches, start=1):
        profiling = bool(profile_dir and profile_batch and i == profile_batch)
        if profiling:
            import os

            from x3d_tpu_torch.tools.trace import device_profiler

            prof = device_profiler()
            prof.start()
        out = eval_step(state, batch)
        if profiling:
            torch.cuda.synchronize()
            prof.stop()
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(profile_dir, f"eval_batch{i}.json"))
            log.info("eval profile trace of batch %d written to %s",
                     i, profile_dir)
        totals = out if totals is None else {
            k: totals[k] + v for k, v in out.items()}
    mesh = getattr(state.model, "mesh", None)
    if mesh is not None and mesh.distributed:
        totals = _all_reduce_sums(totals, mesh)
    host = _to_host(totals) if totals is not None else {}
    n = max(host.get("count", 0.0), 1.0)
    return {
        "loss": host.get("loss_sum", 0.0) / n,
        "acc": host.get("acc_sum", 0.0) / n,
        "top_5_acc": host.get("top_5_sum", 0.0) / n,
        "count": n,
    }


def _all_reduce_sums(totals, mesh) -> Dict[str, torch.Tensor]:
    """The eval sums over the data group, in float64 (a rank with no batch
    adds zeros)."""
    keys = ("count", "loss_sum", "acc_sum", "top_5_sum")
    vec = torch.zeros(len(keys), dtype=torch.float64, device=mesh.device)
    if totals is not None:
        vec = torch.stack([totals[k].to(mesh.device, torch.float64)
                           for k in keys])
    torch.distributed.all_reduce(vec, group=mesh.data_group)
    return dict(zip(keys, vec))


def fit(
    cfg,
    state,
    train_step: Callable,
    train_batches: Iterator[dict],
    steps_per_epoch: int,
    epochs: int,
    seed: int,
    initial_epoch: int = 0,
    eval_step: Optional[Callable] = None,
    val_batches_fn: Optional[Callable[[], Iterable[dict]]] = None,
    hooks: Sequence[Hook] = (),
    metrics_every: int = 1,
    initial_step_in_epoch: int = 0,
):
    """Run the training loop; returns the final state.

    ``seed`` seeds the dropout masks: step n draws from a generator seeded
    from (seed, n), so a resumed run continues the uninterrupted one's
    masks.

    ``val_batches_fn`` is called at each epoch end to produce a fresh
    validation iterator.

    ``initial_step_in_epoch``: resume offset within ``initial_epoch`` (used
    by step-cadence checkpoint resume; the remaining epochs start at 0).

    ``metrics_every``: device->host metric fetch cadence.  A fetch
    synchronises the host with the card, so production runs fetch only at
    the logging cadence; steps in between leave their metrics on the
    device.
    """
    plan = (Epoch(epoch, lr_for_epoch(cfg, epoch), epoch * steps_per_epoch,
                  steps_per_epoch,
                  initial_step_in_epoch if epoch == initial_epoch else 0,
                  lambda: train_batches)
            for epoch in range(initial_epoch, epochs))
    return run_epochs(state, train_step, plan, seed, eval_step=eval_step,
                      val_batches_fn=val_batches_fn, hooks=hooks,
                      metrics_every=metrics_every)


@dataclass(frozen=True)
class Epoch:
    """One epoch as :func:`run_epochs` runs it."""
    index: int                 # 0-based; ``on_epoch_end`` gets it 1-based
    lr: float                  # handed to ``on_epoch_start``
    first_step: int            # the global step before the epoch's first
    steps: int                 # steps in the epoch
    start: int                 # the step-in-epoch to start at (resume)
    batches: Callable[[], Iterator[dict]]   # asked after on_epoch_start


def run_epochs(state, train_step: Callable, epochs: Iterable[Epoch],
               seed: int, eval_step: Optional[Callable] = None,
               val_batches_fn: Optional[Callable[[], Iterable[dict]]] = None,
               hooks: Sequence[Hook] = (), metrics_every: int = 1,
               before_val: Optional[Callable] = None):
    """The loop that :func:`fit` and ``multigrid.fit_multigrid`` share:
    hooks, the dropout generator, the metric cadence and per-epoch
    validation over ``epochs``, each epoch's step ``i`` being the global
    step ``first_step + i + 1``.  ``before_val``: an optional ``state ->
    state`` run before each validation pass.  Returns the final state."""
    generator = None
    for ep in epochs:
        for h in hooks:
            h.on_epoch_start(ep.index, ep.lr)
        batches = ep.batches()
        if generator is None:
            device = next(state.model.parameters()).device
            generator = torch.Generator(device=device).manual_seed(seed)

        last_metrics: Dict[str, float] = {}
        for i in range(ep.start, ep.steps):
            batch = next(batches)
            state, metrics = train_step(state, batch, generator)
            step = ep.first_step + i + 1
            if step % metrics_every == 0 or i == ep.steps - 1:
                host_metrics = _to_host(metrics)
                last_metrics = host_metrics
                for h in hooks:
                    h.on_step(step, host_metrics)
            for h in hooks:
                # every step, with the live state (checkpoint cadence is
                # independent of the metric-fetch cadence)
                h.on_step_end(step, state)

        val_metrics = None
        if eval_step is not None and val_batches_fn is not None:
            if before_val is not None:
                state = before_val(state)
            val_metrics = evaluate(eval_step, state, val_batches_fn())

        for h in hooks:
            # epochs are reported 1-based, matching the reference's ckpt-N
            h.on_epoch_end(ep.index + 1, state, last_metrics, val_metrics)

    for h in hooks:
        h.on_train_end()
    return state
