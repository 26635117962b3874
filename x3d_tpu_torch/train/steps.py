"""Train and eval steps: loss, metrics and the L2 penalty.

As in the JAX package (``x3d_tpu/train/steps.py``): the loss is the
cross-entropy of the float32 logits plus ``weight_decay * sum(w^2)`` over
every conv and dense kernel except the Squeeze-Excite block's first layer
(``se_fc1``), biases and BN variables excluded; the metrics are top-1 and
top-5 accuracy.  The dropout mask of step n is drawn from a generator
seeded from (the caller's generator's seed, n, the data rank), so a step
is a function of its arguments, as the JAX step folds the step into its
key, and data ranks do not repeat one mask.

On a mesh of processes (the model's ``mesh``, ``parallel.init_mesh``) the
train step averages the gradients over the data group after the backward
pass, in one coalesced all-reduce that also averages the metrics and, with
per-replica BN (``TPU.SYNC_BN: False``), the BN running statistics; so W
data ranks take the step the JAX package takes on their global batch.  The
eval step's sums stay local: ``loop.evaluate`` reduces them once.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from x3d_tpu_torch import ops, parallel
from x3d_tpu_torch.train.state import TrainState

_MASK64 = (1 << 64) - 1


def l2_penalty(model: nn.Module) -> torch.Tensor:
    """``sum(w^2)`` in float32 over the regularised kernels: every conv and
    dense ``weight`` and every depthwise ``kernel``, except ``se_fc1``'s.
    A head split over the model group adds its shards' sums over the group
    (each shard's gradient stays its own)."""
    total = None
    split = getattr(model, "head_split", {})
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[-1] not in ("weight", "kernel") or "se_fc1" in parts:
            continue
        sq = p.to(torch.float32).square().sum()
        if name in split:
            sq = parallel.reduce_from_model(sq, model.mesh.model_group)
        total = sq if total is None else total + sq
    return total


def _topk_correct(logits_or_probs: torch.Tensor, labels: torch.Tensor,
                  k: int) -> torch.Tensor:
    k = min(k, logits_or_probs.shape[-1])  # fewer classes than k: top-all
    top = logits_or_probs.topk(k, dim=-1).indices
    return (top == labels[:, None]).any(dim=-1)


def step_seed(seed: int, step: int, rank: int = 0) -> int:
    """A 63-bit seed from (seed, step, data rank): splitmix64 of their
    combination (rank 0's is one process's)."""
    z = (seed + (step + 1) * 0x9E3779B97F4A7C15
         + rank * 0xD1B54A32D192ED03) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def make_train_step(model: nn.Module, weight_decay: float):
    """Build the training step ``(state, batch, generator) -> (state,
    metrics)``.

    ``batch`` holds ``video`` (B, T, S, S, C) and ``label`` (B,) on the
    model's device; ``generator`` is a ``torch.Generator`` on that device,
    whose seed and the step counter seed the step's dropout mask.  The step
    updates the model, its BN running statistics and the optimizer in
    place and advances ``state.step``; the metrics stay on the device.

    Under an open ``ops.span_log`` a step records the span ``train.step``
    (with its ``step`` and ``clips``) around ``train.forward`` (the model,
    the loss and the metrics), ``train.backward`` (``zero_grad`` and the
    backward pass), ``train.reduce`` (the mesh's all-reduce, only where
    there is one) and ``train.optimizer`` (the update).
    """

    mesh = getattr(model, "mesh", None)
    reduce = mesh is not None and mesh.distributed
    data_rank = mesh.data_rank if mesh is not None else 0

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if state.model is not model:
            raise ValueError("the state holds another model than this step")
        with ops.span("train.step") as span:
            if span is not None:
                span.update(step=state.step, clips=int(batch["label"]
                                                       .shape[0]))
            model.train()
            lr = state.schedule(state.step)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            dropout = torch.Generator(device=generator.device)
            dropout.manual_seed(step_seed(generator.initial_seed(),
                                          state.step, data_rank))
            label = batch["label"]
            with ops.span("train.forward"):
                logits = model(batch["video"], return_logits=True,
                               generator=dropout)
                ce = F.cross_entropy(logits.to(torch.float32), label)
                loss = ce + weight_decay * l2_penalty(model)
                with torch.no_grad():
                    metrics = {
                        "loss": loss.detach(),
                        "acc": (logits.argmax(-1) == label)
                        .to(torch.float32).mean(),
                        "top_5_acc": _topk_correct(logits, label, 5)
                        .to(torch.float32).mean(),
                    }
            with ops.span("train.backward"):
                state.optimizer.zero_grad(set_to_none=True)
                loss.backward()
            if reduce:
                with ops.span("train.reduce"):
                    grads = []
                    for p in model.parameters():
                        if p.grad is None:
                            p.grad = torch.zeros_like(p)
                        grads.append(p.grad)
                    stats = [] if model.sync_bn \
                        else parallel.running_stats(model)
                    parallel.all_reduce_mean_(
                        grads + list(metrics.values()) + stats,
                        mesh.data_group, mesh.data)
            with ops.span("train.optimizer"):
                state.optimizer.step()
            state.step += 1
        return state, metrics

    return train_step


def make_eval_step(model: nn.Module):
    """Build the eval step ``(state, batch) -> metric sums``.

    ``batch['video']`` holds videos × views clips; the eval-mode model
    averages each video's view probabilities, so the metrics compare
    per-video predictions with per-video labels.  Sums (not means) let the
    caller aggregate over a dataset whose size the batch does not divide.
    """

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        if state.model is not model:
            raise ValueError("the state holds another model than this step")
        model.eval()
        probs = model(batch["video"])
        label = batch["label"]
        # CE on the ensembled probabilities, clipped as Keras evaluate does
        p_true = probs.gather(1, label[:, None])[:, 0]
        ce = -torch.log(p_true.clamp(1e-7, 1.0))
        return {
            "count": torch.tensor(float(label.shape[0]), device=probs.device),
            "loss_sum": ce.sum(),
            "acc_sum": (probs.argmax(-1) == label).sum(),
            "top_5_sum": _topk_correct(probs, label, 5).sum(),
        }

    return eval_step
