"""Shared CLI plumbing for the train / eval / predict tools."""

from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence

import torch

from x3d_tpu_torch import get_default_config
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
                  device=None, seed: int = 0):
    """Device, model and compute dtype for a run: ``(device, model,
    dtype)``.

    CUDA unless the caller passes another ``device``; raises when there is
    no card.  ``num_gpus`` above 1 is not ported yet.  Debug
    mode turns on autograd's anomaly detection (a NaN in the backward
    raises where it was made) and debug logging.  The model's weights are
    drawn from ``seed``.  cuDNN runs its deterministic algorithms, and
    without ``mixed_precision`` no float32 conv or product runs in TF32
    (process-wide flags).
    """
    if num_gpus and num_gpus > 1:
        raise NotImplementedError(
            f"{num_gpus} GPUs: multi-GPU training is not ported yet "
            "(ROADMAP A10)")
    if debug:
        torch.autograd.set_detect_anomaly(True)
        logging.getLogger().setLevel(logging.DEBUG)
    device = resolve_device(device)
    dtype = torch.bfloat16 if mixed_precision else torch.float32
    use_deterministic_cudnn()
    if dtype == torch.float32:
        use_full_float32()
    model = create_model(cfg, dtype=dtype, device=device, seed=seed)
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


def flat_opts(opts) -> list:
    """``--opts`` as one flat list of tokens."""
    return [tok for group in opts for tok in group]
