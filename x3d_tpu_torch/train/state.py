"""Train state: the model, its optimizer, the LR schedule and the step.

The JAX package's state is an immutable pytree (``x3d_tpu/train/state.py``);
here the model's parameters and BN running statistics and the optimizer's
state are updated in place, and :class:`TrainState` holds what a step
needs.  The optimizers have the update rules of the JAX package's optax
ones: SGD with Nesterov momentum in optax's trace form (torch's
``SGD(nesterov=True)`` without dampening), or Adam at optax's defaults.
Weight decay is not the optimizer's: it enters the loss as an L2 penalty
(``steps.l2_penalty``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import torch
import torch.nn as nn

from x3d_tpu_torch import parallel
from x3d_tpu_torch.train.schedule import make_lr_schedule


@dataclass
class TrainState:
    step: int                                  # global optimizer step
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]           # step -> LR


def make_optimizer(cfg, params: Iterable[torch.Tensor]
                   ) -> torch.optim.Optimizer:
    """SGD with Nesterov momentum (TRAIN.MOMENTUM) or Adam, as the config's
    TRAIN.OPTIMIZER says.  The LR is set from the schedule before each step
    by the train step."""
    name = cfg.TRAIN.OPTIMIZER.lower()
    if name == "sgd":
        return torch.optim.SGD(params, lr=0.0, momentum=cfg.TRAIN.MOMENTUM,
                               nesterov=True)
    if name == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    raise NotImplementedError(
        f"optimizer {cfg.TRAIN.OPTIMIZER!r} not supported")


def create_train_state(cfg, model: nn.Module,
                       steps_per_epoch: Optional[int] = None,
                       schedule: Optional[Callable[[int], float]] = None
                       ) -> TrainState:
    """Wrap an initialised model (``models.create_model``) in a TrainState
    at step 0, with the config's optimizer and LR schedule.  An epoch of the
    schedule is ``steps_per_epoch`` steps, by default TRAIN.DATASET_SIZE //
    TRAIN.BATCH_SIZE; ``schedule`` (step -> LR, e.g. a multigrid
    schedule's ``make_lr_schedule()``) replaces it.

    On a mesh of processes (the model's ``mesh``) every data rank starts
    from data rank 0's parameters and buffers (one broadcast over the data
    group): ranks that drew their weights from one seed hold them
    already."""
    if schedule is None:
        if steps_per_epoch is None:
            steps_per_epoch = max(
                1, cfg.TRAIN.DATASET_SIZE // cfg.TRAIN.BATCH_SIZE)
        schedule = make_lr_schedule(cfg, steps_per_epoch)
    parallel.sync_state_(model, getattr(model, "mesh", None))
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(cfg, model.parameters()),
                      schedule=schedule)
