"""Shared CLI plumbing for the train / eval / predict tools."""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Sequence

import torch

from x3d_tpu_torch import get_default_config, parallel
from x3d_tpu_torch.models import create_model
from x3d_tpu_torch.utils import (resolve_device, use_deterministic_cudnn,
                                 use_full_float32)

log = logging.getLogger(__name__)


def load_config(config_path: str, opts: Optional[Sequence[str]] = None):
    """The default config merged with a YAML file and ``opts`` overrides,
    frozen.  Each ``opts`` entry is "KEY VALUE", "KEY=VALUE", or a single
    token of such a pair."""
    if not config_path.endswith((".yaml", ".yml")):
        raise ValueError("Please provide a path to a yaml file.")
    cfg = get_default_config()
    cfg.merge_from_file(config_path)
    if opts:
        flat = []
        for o in opts:
            flat.extend(o.replace("=", " ").split())
        cfg.merge_from_list(flat)
    cfg.freeze()
    return cfg


def setup_runtime(cfg, num_gpus: int, mixed_precision: bool, debug: bool,
                  device=None, seed: int = 0, multihost: bool = False,
                  init_method: Optional[str] = None):
    """Device, model and compute dtype for a run: ``(device, model,
    dtype)``; the model's ``mesh`` is the run's place among its processes
    (None in a run of one process without a process group).

    One process per GPU: ``num_gpus`` above 1 (one node) and ``multihost``
    run under torchrun, whose environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``, or ``init_method``)
    the process group is formed from; a process started by torchrun joins
    its group whatever ``num_gpus`` says.  The mesh is ``TPU.MESH_DATA`` x
    ``TPU.MESH_MODEL`` over the processes, on ``cuda:LOCAL_RANK`` with
    NCCL unless ``device`` is given (``cpu``: gloo); BN statistics are the
    global batch's with ``TPU.SYNC_BN`` and each rank's own batch's
    without it (one group a rank: the JAX package's ``bn_groups = data``).
    A group that cannot be formed raises; nothing falls back to fewer
    processes or to another backend.

    CUDA unless the caller passes another ``device``; raises when there is
    no card.  Debug mode turns on autograd's anomaly detection (a NaN in
    the backward raises where it was made) and debug logging.  The model's
    weights are drawn from ``seed``.  cuDNN runs its deterministic
    algorithms, and without ``mixed_precision`` no float32 conv or product
    runs in TF32 (process-wide flags).
    """
    mesh = None
    if num_gpus and num_gpus > 1 or multihost or parallel.in_torchrun():
        flag = "--multihost" if multihost else f"{num_gpus} GPUs"
        if not parallel.in_torchrun():
            raise RuntimeError(
                f"{flag}: one process per GPU, started by torchrun (no "
                "RANK / WORLD_SIZE in the environment): torchrun "
                f"--nproc_per_node={max(num_gpus or 1, 1)} -m "
                "x3d_tpu_torch.tools.train ... --num_gpus N")
        world = int(os.environ["WORLD_SIZE"])
        if num_gpus and num_gpus > 1 and not multihost \
                and num_gpus != world:
            raise ValueError(f"--num_gpus={num_gpus} but torchrun started "
                             f"{world} processes")
        mesh = parallel.mesh_from_config(cfg, device=device,
                                         init_method=init_method)
        device = mesh.device
        log.info("process %d of %d: mesh %s, %s on %s", mesh.rank,
                 mesh.world, mesh.shape, mesh.backend, device)
    if debug:
        torch.autograd.set_detect_anomaly(True)
        logging.getLogger().setLevel(logging.DEBUG)
    device = resolve_device(device)
    dtype = torch.bfloat16 if mixed_precision else torch.float32
    use_deterministic_cudnn()
    if dtype == torch.float32:
        use_full_float32()
    model = create_model(cfg, dtype=dtype, device=device, seed=seed,
                         mesh=mesh)
    log.info("device=%s dtype=%s%s", device, dtype,
             f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else "")
    return device, model, dtype


def _str2bool(text: str) -> bool:
    if text.lower() in ("1", "true", "t", "yes", "y"):
        return True
    if text.lower() in ("0", "false", "f", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {text!r}")


def add_bool_flag(parser: argparse.ArgumentParser, name: str, default: bool,
                  help: str) -> None:
    """A boolean flag in the forms the reference's CLIs take: ``--name``,
    ``--name=false`` and ``--noname``."""
    parser.add_argument(f"--{name}", dest=name, nargs="?", const=True,
                        default=default, type=_str2bool, help=help)
    parser.add_argument(f"--no{name}", dest=name, action="store_false",
                        help=argparse.SUPPRESS)


def add_common_flags(parser: argparse.ArgumentParser) -> None:
    """``--opts`` (repeatable config overrides) and ``--device``."""
    parser.add_argument("--opts", action="append", nargs="+", default=[],
                        metavar="KEY VALUE",
                        help="Config overrides: KEY VALUE pairs.")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu.")


def add_parallel_flags(parser: argparse.ArgumentParser) -> None:
    """``--init_method``: the process group's rendezvous."""
    parser.add_argument("--init_method", default=None,
                        help="The process group's rendezvous for torchrun's "
                             "ranks: env:// (the default: MASTER_ADDR, "
                             "MASTER_PORT) or file:///path.")


def flat_opts(opts) -> list:
    """``--opts`` as one flat list of tokens."""
    return [tok for group in opts for tok in group]


def remat_flag(text: str):
    """A ``--remat`` value as ``create_model`` takes it, the JAX tools'
    mapping: "auto" is None (the config's ``TPU.REMAT``), "true" True,
    "false" and "off" False, any other mode as given."""
    return {"auto": None, "true": True, "false": False,
            "off": False}.get(str(text).lower(), str(text).lower())


def fold_flag(text: str):
    """A ``--fold`` value (config/auto/on/off) as ``create_model``'s
    ``time_fold``: None (the config's), "auto", True or False."""
    return {"config": None, "auto": "auto", "on": True, "true": True,
            "off": False, "false": False}[str(text).lower()]
