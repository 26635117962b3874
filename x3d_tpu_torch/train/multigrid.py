"""Long-cycle multigrid training (Wu et al., CVPR 2020).

The counterpart of the JAX package's ``x3d_tpu/train/multigrid.py``, with
its schedule, precise-BN recalibration and loop.  Most epochs train on
coarse clip shapes (fewer frames, smaller crops) at proportionally larger
batches, keeping a mini-batch's cost ``B*T*S^2`` roughly constant, and the
run anneals to the base shape for a trailing fine-tuning segment.  Only the
long cycle exists, as in the JAX package.

Each phase is a new input shape for the one train step; the port's kernels
take any shape, so nothing is built per phase.  The learning rate follows
the linear-scaling rule per phase (``lr * batch_multiplier``) and is a
function of the global step over the phases' epoch boundaries, so it
resumes with the step.

BN: the running statistics accumulate across shapes;
:func:`make_bn_recalibrator` re-estimates them over N base-shape batches
before validation (``MULTIGRID.BN_RECALC_BATCHES``), the paper's precise BN.
"""

from __future__ import annotations

import functools
import logging
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from x3d_tpu_torch import parallel
from x3d_tpu_torch.train.hooks import Hook
from x3d_tpu_torch.train.loop import Epoch, run_epochs
from x3d_tpu_torch.train.schedule import lr_for_epoch

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class Phase:
    """One long-cycle shape: the clip geometry and batch for some epochs."""
    index: int                 # index into LONG_CYCLE_FACTORS
    temp_duration: int         # frames per clip (T)
    crop_size: int             # spatial crop (S)
    jitter_scales: tuple       # scaled TRAIN_JITTER_SCALES
    batch_size: int            # batch for this phase
    lr_scale: float            # linear-scaling-rule LR multiplier
    steps_per_epoch: int       # one data pass at this phase's batch

    def apply_to_config(self, cfg):
        """A clone of ``cfg`` carrying this phase's geometry (for building
        per-phase input pipelines and synthetic batches)."""
        phase_cfg = cfg.clone()
        phase_cfg.DATA.TEMP_DURATION = self.temp_duration
        phase_cfg.DATA.TRAIN_CROP_SIZE = self.crop_size
        phase_cfg.DATA.TRAIN_JITTER_SCALES = list(self.jitter_scales)
        phase_cfg.TRAIN.BATCH_SIZE = self.batch_size
        return phase_cfg


def _round_to(value: float, divisor: int) -> int:
    return max(divisor, int(round(value / divisor)) * divisor)


class MultigridSchedule:
    """Deterministic epoch -> phase assignment and the step -> LR schedule.

    A pure function of (cfg, base_steps_per_epoch, epochs), rebuilt
    identically on resume.  Every epoch sees about one dataset pass
    (``phase.batch_size * phase.steps_per_epoch ~= base_batch *
    base_steps``), so the per-epoch cosine LR applies unchanged, scaled by
    the phase's batch multiplier.
    """

    def __init__(self, cfg, base_steps_per_epoch: int, epochs: int):
        mg = cfg.MULTIGRID
        factors = [tuple(f) for f in mg.LONG_CYCLE_FACTORS]
        if not factors or tuple(factors[-1]) != (1.0, 1.0):
            raise ValueError(
                "MULTIGRID.LONG_CYCLE_FACTORS must end with the base shape "
                f"[1.0, 1.0]; got {factors}")
        base_T = cfg.DATA.TEMP_DURATION
        base_S = cfg.DATA.TRAIN_CROP_SIZE
        base_B = cfg.TRAIN.BATCH_SIZE
        divisor = mg.SPATIAL_DIVISOR

        self.phases = []
        for i, (tf, sf) in enumerate(factors):
            bmult = max(1, int(round(1.0 / (tf * sf * sf))))
            T = max(1, int(round(base_T * tf)))
            S = _round_to(base_S * sf, divisor)
            # the jitter scales shrink with the crop; ``max(S, ...)`` is a
            # floor only (the short-side resize must reach the crop).  Where
            # it binds at both ends the phase resizes deterministically:
            # warn, don't fail
            jitter = tuple(max(S, int(round(j * sf)))
                           for j in cfg.DATA.TRAIN_JITTER_SCALES)
            if len(set(jitter)) == 1 and len(jitter) > 1:
                log.warning(
                    "multigrid phase %d: jitter range collapsed to %s "
                    "(crop %d floor); scale augmentation is disabled for "
                    "this phase", i, jitter, S)
            self.phases.append(Phase(
                index=i,
                temp_duration=T,
                crop_size=S,
                jitter_scales=jitter,
                batch_size=base_B * bmult,
                lr_scale=float(bmult),
                steps_per_epoch=max(1, base_steps_per_epoch // bmult),
            ))

        # Epochs cycle coarse -> fine in EPOCH_BLOCK-epoch blocks, the
        # trailing FINETUNE_FRACTION (at least the final epoch) pinned to the
        # base shape.  The cycled segment is aligned backwards from the
        # fine-tune boundary, so its last block is the base phase; a leading
        # remainder extends the coarsest phase.
        n_fine = max(1, int(round(epochs * mg.FINETUNE_FRACTION)))
        n_fine = min(n_fine, epochs)
        block = max(1, mg.EPOCH_BLOCK)
        n_phases = len(self.phases)
        n_cycled = epochs - n_fine
        remainder = n_cycled % (block * n_phases)
        self.epoch_phase = []
        for epoch in range(epochs):
            if epoch >= n_cycled:
                self.epoch_phase.append(n_phases - 1)
            elif remainder == n_cycled:
                # shorter than one cycle: the tail of one cycle, walked
                # backwards from the boundary (clamped to the coarsest)
                k = (n_cycled - 1 - epoch) // block
                self.epoch_phase.append(max(0, n_phases - 1 - k))
            elif epoch < remainder:
                self.epoch_phase.append(0)
            else:
                self.epoch_phase.append(
                    ((epoch - remainder) // block) % n_phases)
        self.epochs = epochs
        self.cfg = cfg

        # first_step[e]: the global step at which epoch e begins;
        # first_step[epochs]: the total
        steps = [self.phases[p].steps_per_epoch for p in self.epoch_phase]
        self.first_step = np.concatenate([[0], np.cumsum(steps)]).astype(
            np.int64)

    # -- queries -----------------------------------------------------------
    def phase_for_epoch(self, epoch: int) -> Phase:
        return self.phases[self.epoch_phase[epoch]]

    def lr_for_epoch_scaled(self, epoch: int) -> float:
        return lr_for_epoch(self.cfg, epoch) \
            * self.phase_for_epoch(epoch).lr_scale

    def total_steps(self) -> int:
        return int(self.first_step[-1])

    def position_for_step(self, step: int):
        """A resumed optimizer step -> (epoch, step_in_epoch).  A step at
        or past the end maps to ``(epochs, 0)``, so a finished run resumes
        as a no-op (replaying the last epoch would rerun its hooks,
        validation and BN recalibration)."""
        step = max(step, 0)
        if step >= self.total_steps():
            return self.epochs, 0
        epoch = int(np.searchsorted(self.first_step, step, side="right")) - 1
        return epoch, int(step - self.first_step[epoch])

    def make_lr_schedule(self) -> Callable[[int], float]:
        """step -> LR over the phase-aware epoch boundaries: the scaled LRs
        rounded to float32, as the JAX package's schedule holds them; steps
        past the end keep the last epoch's."""
        boundaries = self.first_step[1:]
        lrs = np.asarray([self.lr_for_epoch_scaled(e)
                          for e in range(self.epochs)], np.float32)

        def schedule(step: int) -> float:
            idx = int(np.searchsorted(boundaries, int(step), side="right"))
            return float(lrs[min(max(idx, 0), self.epochs - 1)])

        return schedule

    def describe(self) -> str:
        lines = []
        for p in self.phases:
            n = self.epoch_phase.count(p.index)
            lines.append(
                f"phase {p.index}: {p.temp_duration}x{p.crop_size}^2 "
                f"batch {p.batch_size} (lr x{p.lr_scale:g}, "
                f"{p.steps_per_epoch} steps/epoch, {n} epochs)")
        return "\n".join(lines)


def make_bn_recalibrator(model: torch.nn.Module,
                         batches_fn: Callable[[], Iterable[dict]],
                         num_batches: int, seed: int,
                         momentum: float) -> Callable:
    """Precise BN: ``state -> state`` that REPLACES every BatchNorm's
    running statistics with the plain average of ``num_batches`` batches'
    statistics (training-mode forwards without gradients; parameters
    untouched).

    Every BatchNorm folds a batch in as ``new = m*old + (1-m)*batch``, the
    stem's and the projections' from their own pass, the fused segments'
    bn_a, bn_b and bn_c from the kernels' sums, so each batch's statistic
    is recovered by inverting that against the unchanged statistics:
    ``batch = (new - m*old) / (1-m)``.  The port's BatchNorm updates its
    buffers in place, so every batch starts from a snapshot of them, which
    is put back after the batch is read; the average then replaces them.
    No remat region recomputes without gradients.  The model's mode is
    restored afterwards.  ``seed`` seeds the head's dropout mask, which no
    statistic depends on.  On a mesh of processes with per-replica BN
    (``TPU.SYNC_BN: False``) the ranks' averages are averaged over the data
    group; with synced BN every rank's statistics are the global batch's
    already.  Every rank runs the same number of batches.
    """
    from x3d_tpu_torch.models.x3d import BatchNorm

    norms = [m.norm for m in model.modules() if isinstance(m, BatchNorm)]

    def recalibrate(state):
        if state.model is not model:
            raise ValueError("the state holds another model than this "
                             "recalibrator")
        device = next(model.parameters()).device
        generator = torch.Generator(device=device).manual_seed(seed)
        old = [(n.mean.clone(), n.var.clone()) for n in norms]
        was_training = model.training
        acc, count = None, 0
        it = iter(batches_fn())
        try:
            model.train()
            with torch.no_grad():
                for _ in range(num_batches):
                    batch = next(it, None)
                    if batch is None:
                        break
                    try:
                        model(batch["video"], return_logits=True,
                              generator=generator)
                        stats = [((n.mean - momentum * m) / (1.0 - momentum),
                                  (n.var - momentum * v) / (1.0 - momentum))
                                 for n, (m, v) in zip(norms, old)]
                    finally:
                        for n, (m, v) in zip(norms, old):
                            n.mean.copy_(m)
                            n.var.copy_(v)
                    acc = stats if acc is None else [
                        (a + m, b + v) for (a, b), (m, v) in zip(acc, stats)]
                    count += 1
        finally:
            model.train(was_training)
        if count:
            with torch.no_grad():
                for n, (m, v) in zip(norms, acc):
                    n.mean.copy_(m / count)
                    n.var.copy_(v / count)
        if not getattr(model, "sync_bn", True):
            parallel.average_running_stats_(model)
        return state

    return recalibrate


def _close(iterators) -> None:
    for it in iterators:
        close = getattr(it, "close", None)
        if close is not None:
            close()


def fit_multigrid(
    cfg,
    state,
    train_step: Callable,
    schedule: MultigridSchedule,
    batches_for_phase: Callable[[Phase], Iterator[dict]],
    seed: int,
    initial_epoch: int = 0,
    initial_step_in_epoch: int = 0,
    eval_step: Optional[Callable] = None,
    val_batches_fn: Optional[Callable[[], Iterable[dict]]] = None,
    hooks: Sequence[Hook] = (),
    metrics_every: int = 1,
    bn_recal_fn: Optional[Callable] = None,
):
    """The multigrid training loop; returns the final state.

    ``loop.run_epochs``, the loop ``loop.fit`` runs (the dropout generator
    from ``seed``, hooks, metric cadence, per-epoch validation), with each
    epoch's shape, batch and steps taken from ``schedule``; the global step of an epoch's i-th step is
    ``first_step[epoch] + i + 1`` and ``on_epoch_start`` gets the scaled
    LR.  An iterator is created on its phase's first epoch and kept for the
    phase's later epochs; every iterator it made is closed when it returns
    or raises (the port's readers own a thread and a CUDA stream each).

    ``bn_recal_fn``: optional ``state -> state`` run before each validation
    pass (:func:`make_bn_recalibrator`).
    """
    iters: Dict[int, Iterator[dict]] = {}

    def phase_batches(epoch: int, phase: Phase) -> Iterator[dict]:
        if phase.index not in iters:
            log.info("multigrid epoch %d -> phase %d (%dx%d^2, batch %d)",
                     epoch, phase.index, phase.temp_duration,
                     phase.crop_size, phase.batch_size)
            iters[phase.index] = batches_for_phase(phase)
        return iters[phase.index]

    plan = (Epoch(epoch, schedule.lr_for_epoch_scaled(epoch),
                  int(schedule.first_step[epoch]), phase.steps_per_epoch,
                  initial_step_in_epoch if epoch == initial_epoch else 0,
                  functools.partial(phase_batches, epoch, phase))
            for epoch in range(initial_epoch, schedule.epochs)
            for phase in [schedule.phase_for_epoch(epoch)])
    try:
        return run_epochs(state, train_step, plan, seed, eval_step=eval_step,
                          val_batches_fn=val_batches_fn, hooks=hooks,
                          metrics_every=metrics_every,
                          before_val=bn_recal_fn)
    finally:
        _close(iters.values())
