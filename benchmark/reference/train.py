"""The reference training step, in plain PyTorch and float32.

The loss is the cross-entropy of the logits plus ``WEIGHT_DECAY`` times the
sum of squares of the regularised kernels (``x3d.weight_leaves``); the
optimizer SGD with Nesterov momentum, ``buf = momentum * buf + grad`` (the
first ``buf`` the gradient) and ``p -= lr * (grad + momentum * buf)``; the
LR a linear warmup by epoch from ``WARMUP_LR`` to ``BASE_LR`` over
``WARMUP_EPOCHS``, then a half cosine over ``EPOCHS``.

The dropout mask of step n on data rank r is drawn by ``torch.rand`` from a
generator on the run's device seeded with ``step_seed(seed, n, r)``: the
rule the program under test documents for its masks (a splitmix64 of the
three), copied here so that both draw the same mask from the same seed.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import x3d

_MASK64 = (1 << 64) - 1


def step_seed(seed: int, step: int, rank: int = 0) -> int:
    z = (seed + (step + 1) * 0x9E3779B97F4A7C15
         + rank * 0xD1B54A32D192ED03) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def dropout_keep(seed: int, step: int, ranks: int, rows: int, rate: float,
                 device) -> torch.Tensor:
    """The (ranks * rows, 2048) keep mask of one step over the global
    batch, rank by rank."""
    out = []
    for r in range(ranks):
        g = torch.Generator(device=device)
        g.manual_seed(step_seed(seed, step, r))
        out.append(torch.rand((rows, x3d.HEAD_WIDTH), generator=g,
                              device=device) < 1.0 - rate)
    return torch.cat(out)


def lr_at(train: dict, step: int, steps_per_epoch: int) -> float:
    """The LR of a step, in float32 arithmetic."""
    f32 = np.float32
    e = f32(step // steps_per_epoch)
    if e > f32(train["WARMUP_EPOCHS"]):
        angle = f32(math.pi) * e / f32(train["EPOCHS"])
        return float(f32(train["BASE_LR"] * 0.5)
                     * (f32(np.cos(angle)) + f32(1.0)))
    return float(f32(train["WARMUP_LR"]) + e
                 * f32(train["BASE_LR"] - train["WARMUP_LR"])
                 / f32(train["WARMUP_EPOCHS"]))


def run_steps(model: x3d.X3D, batches: Sequence[Dict[str, torch.Tensor]],
              keeps: Sequence[torch.Tensor], lrs: Sequence[float],
              momentum: float, weight_decay: float,
              checkpointed: bool = True) -> dict:
    """Train ``model`` in place for ``len(batches)`` steps.  Returns the
    losses, the first step's gradients and the state after it."""
    model.train()
    params = dict(model.named_parameters())
    decayed = x3d.weight_leaves(model)
    bufs: Dict[str, torch.Tensor] = {}
    losses: List[float] = []
    first_grad: Dict[str, torch.Tensor] = {}
    first: Dict[str, torch.Tensor] = {}
    for i, (batch, keep, lr) in enumerate(zip(batches, keeps, lrs)):
        logits = model(batch["video"].to(torch.float32), keep=keep,
                       checkpointed=checkpointed)
        l2 = sum(params[n].square().sum() for n in decayed)
        loss = F.cross_entropy(logits, batch["label"]) + weight_decay * l2
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(loss.item())
        with torch.no_grad():
            for (name, p), g in zip(params.items(), grads):
                if i == 0:
                    first_grad[name] = g.clone()
                    bufs[name] = g.clone()
                else:
                    bufs[name].mul_(momentum).add_(g)
                p.sub_(lr * (g + momentum * bufs[name]))
        if i == 0:
            first = {k: v.clone() for k, v in model.state_dict().items()}
        del grads, logits, loss
    return {"losses": losses, "first_grad": first_grad, "first": first}
