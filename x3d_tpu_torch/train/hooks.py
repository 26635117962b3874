"""Training hooks: the loop's callback system.

The counterpart of the JAX package's ``x3d_tpu/train/hooks.py``, with its
classes and cadences: :class:`LoggingHook` (progress lines with steps/s),
:class:`CheckpointHook` (every epoch end, and every N global steps when
set), :class:`ProfileHook` (a ``torch.profiler`` device trace around one
step), :class:`TensorBoardHook` and :class:`WandbHook`.  The last two are
active only when their package imports (``tensorboard`` through
``torch.utils.tensorboard``; ``wandb``): without it they log a warning once
and do nothing.  Hooks receive host-side scalars; nothing here synchronises
with the device except the two ends of a profile.
"""

from __future__ import annotations

import contextlib
import glob
import json
import logging
import os
import time
from typing import Dict, Optional

log = logging.getLogger(__name__)


class Hook:
    def on_epoch_start(self, epoch: int, lr: float) -> None: ...
    def on_step(self, step: int, metrics: Dict[str, float]) -> None: ...
    def on_step_end(self, step: int, state) -> None:
        """Fires EVERY step with the live TrainState.  ``on_step`` by
        contrast fires only at the host metric-fetch cadence."""
    def on_epoch_end(self, epoch: int, state,
                     train_metrics: Dict[str, float],
                     val_metrics: Optional[Dict[str, float]]) -> None: ...
    def on_train_end(self) -> None: ...


def _fmt(metrics: Dict[str, float]) -> str:
    return " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items()))


class LoggingHook(Hook):
    """Progress lines with steps/sec."""

    def __init__(self, log_every: int = 50):
        self._every = log_every
        self._t0 = time.time()
        self._last_step = 0
        self._cur_step = 0

    def on_epoch_start(self, epoch, lr):
        log.info("epoch %d starting, lr=%.6f", epoch, lr)
        # Restart the rate window at the epoch boundary (epoch-end work --
        # validation, checkpoints -- must not count as step time), and move
        # its step origin too, or a window that crosses an epoch divides the
        # full step delta by the post-boundary time only.
        self._t0 = time.time()
        self._last_step = self._cur_step

    def on_step_end(self, step, state):
        self._cur_step = step

    def on_step(self, step, metrics):
        if step % self._every == 0:
            dt = time.time() - self._t0
            sps = (step - self._last_step) / dt if dt > 0 else 0.0
            self._t0, self._last_step = time.time(), step
            log.info("step %d: %s (%.2f steps/s)", step, _fmt(metrics), sps)

    def on_epoch_end(self, epoch, state, train_metrics, val_metrics):
        msg = _fmt(train_metrics)
        if val_metrics:
            msg += " | val: " + _fmt(val_metrics)
        log.info("epoch %d done: %s", epoch, msg)


class TensorBoardHook(Hook):
    """Event files through ``torch.utils.tensorboard``; inactive when the
    ``tensorboard`` package does not import."""

    def __init__(self, log_dir: str, update_freq: int = 50):
        self._writer = None
        self._freq = update_freq
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            log.warning("tensorboard is not installed; skipping TensorBoard "
                        "event files.")
            return
        self._writer = SummaryWriter(log_dir)

    def on_step(self, step, metrics):
        if self._writer is None or step % self._freq:
            return
        for k, v in metrics.items():
            self._writer.add_scalar(f"train/{k}", v, step)

    def on_epoch_start(self, epoch, lr):
        if self._writer is not None:
            self._writer.add_scalar("lr", lr, epoch)

    def on_epoch_end(self, epoch, state, train_metrics, val_metrics):
        if self._writer is None:
            return
        for k, v in (val_metrics or {}).items():
            self._writer.add_scalar(f"val/{k}", v, epoch)
        self._writer.flush()

    def on_train_end(self):
        if self._writer is not None:
            self._writer.close()


class ProfileHook(Hook):
    """Capture a ``torch.profiler`` device trace around one training step.

    ``on_step`` fires at the metric cadence, so the trace covers the
    logging window that contains ``profile_step``.  It writes a Chrome
    trace ``profile_step<N>.json`` and the per-family summary of
    ``tools/trace.py`` (``profile_step<N>_summary.json``) into ``log_dir``.
    A span log (``ops.span_log``) is open over the window: the steps'
    spans (``train.step`` around ``train.forward``, ``train.backward``,
    ``train.reduce`` on a mesh and ``train.optimizer``) go into the summary
    as host ms and device idle ms a step by span
    (``tools/trace.span_summary``), into the Chrome trace as a host thread,
    and into ``profile_step<N>_spans.json``.
    """

    def __init__(self, log_dir: str, profile_step: int):
        self._dir = log_dir
        self._step = profile_step
        self._prof = None
        self._from = 0
        self._done = False
        self._open = contextlib.ExitStack()
        self._marks = []
        self._anchors = []

    def _stop(self, step: int) -> None:
        import torch

        from x3d_tpu_torch.tools import trace

        self._anchors.append(trace.anchor())
        torch.cuda.synchronize()
        prof, self._prof, self._done = self._prof, None, True
        prof.stop()
        self._open.close()
        n = max(step - self._from, 1)
        summary = trace.summarize(prof, n, "step")
        spans, keys = trace.span_summary(prof, self._marks, self._anchors, n,
                                         "step")
        summary.update(keys)
        os.makedirs(self._dir, exist_ok=True)
        base = os.path.join(self._dir, f"profile_step{self._step}")
        prof.export_chrome_trace(base + ".json")
        if spans:
            trace.chrome_spans(base + ".json", prof, spans)
        with open(base + "_spans.json", "w") as f:
            json.dump(spans, f)
        with open(base + "_summary.json", "w") as f:
            json.dump(summary, f, indent=1)
        log.info("profile trace around step %d written to %s", self._step,
                 self._dir)

    def on_step(self, step, metrics):
        if self._done or not self._step:
            return
        if self._prof is None and step >= self._step - 1:
            from x3d_tpu_torch import ops
            from x3d_tpu_torch.tools import trace

            self._prof, self._from = trace.device_profiler(), step
            self._marks = self._open.enter_context(ops.span_log())
            self._prof.start()
            self._anchors = [trace.anchor()]
        elif self._prof is not None:
            self._stop(step)

    def on_train_end(self):
        if self._prof is not None:
            self._stop(self._from + 1)


class CheckpointHook(Hook):
    """Save the full TrainState, at two cadences:

    * every epoch end (the default), and
    * every ``every_n_steps`` global steps when set
      (``--save_checkpoints_step N``), so a crash loses at most N steps,
      not an epoch.

    Checkpoints are keyed by the **global optimizer step** (``state.step``),
    so resume recovers the exact (epoch, step-in-epoch, LR-schedule) point.
    """

    def __init__(self, manager, every_n_steps: Optional[int] = None):
        self._mgr = manager
        self._every = every_n_steps
        self._last_saved = -1

    def on_step_end(self, step, state):
        if self._every and step % self._every == 0 \
                and step != self._last_saved:
            self._mgr.save(step, state)
            self._last_saved = step
            log.info("checkpoint saved at step %d", step)

    def on_epoch_end(self, epoch, state, train_metrics, val_metrics):
        step = int(state.step)
        if step != self._last_saved:
            self._mgr.save(step, state)
            self._last_saved = step


class WandbHook(Hook):
    """Weights & Biases logging, active only if ``WANDB.ENABLE`` is set and
    wandb is importable.

    * ``WANDB.TENSORBOARD: True`` patches W&B's TensorBoard sync before
      ``wandb.init`` so the :class:`TensorBoardHook`'s event files are
      mirrored to the run.
    * ``checkpoint_dir``: stage the epoch's new checkpoint files into the
      run at each epoch end.
    """

    def __init__(self, cfg, job_type: str = "train",
                 log_dir: Optional[str] = None,
                 checkpoint_dir: Optional[str] = None):
        self._run = None
        self._ckpt_dir = checkpoint_dir
        self._uploaded: Dict[str, float] = {}  # path -> mtime at upload
        if not cfg.WANDB.ENABLE:
            return
        try:
            import wandb
        except ImportError:
            log.warning("WANDB.ENABLE is set but wandb is not installed; "
                        "skipping W&B logging.")
            return
        self._wandb = wandb
        if cfg.WANDB.TENSORBOARD and log_dir:
            try:
                wandb.tensorboard.patch(root_logdir=log_dir)
            except Exception as e:  # pragma: no cover - wandb internals
                log.warning("wandb.tensorboard.patch failed: %s", e)
        self._run = wandb.init(
            job_type=job_type,
            group=cfg.WANDB.GROUP_NAME,
            project=cfg.WANDB.PROJECT_NAME,
            mode=cfg.WANDB.MODE,
            config=dict(cfg),
            resume=True,
        )

    def on_step(self, step, metrics):
        if self._run:
            self._wandb.log({f"train/{k}": v for k, v in metrics.items()},
                            step=step)

    def log_metrics(self, metrics: Dict[str, float],
                    prefix: str = "eval") -> None:
        """One-shot metric log, used by the eval CLI."""
        if self._run:
            self._wandb.log({f"{prefix}/{k}": float(v)
                             for k, v in metrics.items()})

    def on_epoch_end(self, epoch, state, train_metrics, val_metrics):
        if not self._run:
            return
        if val_metrics:
            self._wandb.log({f"val/{k}": v for k, v in val_metrics.items()})
        if self._ckpt_dir:
            # only the per-epoch delta is staged, and one failed save skips
            # that file, not the rest
            for f in glob.glob(os.path.join(self._ckpt_dir, "**"),
                               recursive=True):
                if not os.path.isfile(f):
                    continue
                mtime = os.path.getmtime(f)
                if self._uploaded.get(f) == mtime:
                    continue
                try:
                    self._wandb.save(
                        f, base_path=os.path.dirname(self._ckpt_dir),
                        policy="live")
                    self._uploaded[f] = mtime
                except Exception as e:  # pragma: no cover
                    log.warning("wandb.save(%s) failed: %s", f, e)

    def on_train_end(self):
        if self._run:
            self._run.finish()
