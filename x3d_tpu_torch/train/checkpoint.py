"""Checkpoint save / resume with ``torch.save``.

The counterpart of the JAX package's Orbax manager
(``x3d_tpu/train/checkpoint.py``), with its interface: the save key is any
increasing integer -- the training CLI keys by the **global optimizer
step**, so epoch-end and mid-epoch (step-cadence) saves live in one
directory and resume recovers the exact (epoch, step-in-epoch) point from
the restored ``state.step``.  A checkpoint is one file ``ckpt-<key>.pt``
holding the step, ``model.state_dict()`` (parameters and BN running
statistics) and ``optimizer.state_dict()``; it is written under a temporary
name and renamed, so a killed run leaves no half-written checkpoint.  The
learning rate needs no slot: the schedule is a function of ``state.step``.

The port's :class:`~x3d_tpu_torch.train.state.TrainState` is mutable, so a
restore loads into the given state in place and returns it.

On a mesh of processes (the model's ``mesh``) every rank calls ``save``:
the head's shards are joined into full tensors (a collective over the
model group), rank 0 alone writes, and every rank waits at a barrier until
the file is in place; every rank restores from the file, cutting its head
shards from the full tensors.  The ranks share the checkpoint directory.
"""

from __future__ import annotations

import logging
import os
import re
from typing import List, Optional

import torch

from x3d_tpu_torch import parallel

log = logging.getLogger(__name__)

_NAME = re.compile(r"^ckpt-(\d+)\.pt$")


class CheckpointManager:
    """TrainState checkpoint manager (keys: any increasing int save id)."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._keep = max_to_keep

    @property
    def directory(self) -> str:
        return self._dir

    def _path(self, key: int) -> str:
        return os.path.join(self._dir, f"ckpt-{int(key)}.pt")

    def keys(self) -> List[int]:
        """The save keys present, ascending."""
        found = (_NAME.match(n) for n in os.listdir(self._dir))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, key: int, state) -> None:
        """Persist the full train state under an integer save id, then drop
        the oldest checkpoints beyond ``max_to_keep``."""
        model = state.model
        payload = {"step": int(state.step),
                   "model": parallel.full_model_state(model),
                   "optimizer": parallel.full_optimizer_state(
                       state.optimizer, model)}
        mesh = getattr(model, "mesh", None)
        if mesh is None or mesh.is_main:
            path = self._path(key)
            tmp = f"{path}.{os.getpid()}.tmp"
            torch.save(payload, tmp)
            os.replace(tmp, path)
            if self._keep:
                for old in self.keys()[:-self._keep]:
                    os.remove(self._path(old))
        parallel.barrier(mesh)

    def latest_epoch(self) -> Optional[int]:
        """Latest save key (named for the historical epoch-keyed layout)."""
        keys = self.keys()
        return keys[-1] if keys else None

    latest = latest_epoch

    def _load(self, key: int, state) -> dict:
        device = next(state.model.parameters()).device
        return torch.load(self._path(key), map_location=device,
                          weights_only=True)

    def restore(self, state, epoch: Optional[int] = None):
        """Restore model, optimizer and step into ``state``.

        Returns (state, key); (state, 0) if there is nothing to restore.
        Callers derive the resume point from ``state.step``, not the key.
        """
        epoch = epoch if epoch is not None else self.latest_epoch()
        if epoch is None:
            return state, 0
        payload = self._load(epoch, state)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(parallel.cut_optimizer_state(
            payload["optimizer"], state.optimizer, state.model))
        state.step = int(payload["step"])
        return state, int(epoch)

    def restore_weights_only(self, state, directory: Optional[str] = None,
                             epoch: Optional[int] = None):
        """Load parameters and BN statistics, keep the optimizer and the
        step as they are: the pretrained warm start, and eval's restore.
        Optimizer slots in the checkpoint are ignored."""
        mgr = self if directory is None else CheckpointManager(
            directory, max_to_keep=0)
        epoch = epoch if epoch is not None else mgr.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"No checkpoint found in {mgr._dir}")
        state.model.load_state_dict(mgr._load(epoch, state)["model"])
        return state

    def close(self) -> None:
        """Nothing is pending: every save has been renamed into place."""
