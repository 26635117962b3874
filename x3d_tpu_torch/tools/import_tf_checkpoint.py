"""Import the reference's TensorFlow checkpoints into the port, without
TensorFlow.

The reference publishes TF object-based checkpoints (models/X3D-{XS,S,M})
whose variable paths look like::

    conv1/conv_s/kernel/.ATTRIBUTES/VARIABLE_VALUE
    stages/0/stage/layer_with_weights-1/bottleneck/a/kernel/...
    conv5/layer_with_weights-0/kernel/...   fc1/kernel/...   fc2/bias/...

The counterpart of the JAX package's ``x3d_tpu/tools/import_tf_checkpoint.py``
with its own copy of the path mapping (:func:`map_variable`: the same paths
go to the same ``(collection, key, ...)`` tuples of the Flax tree).  The
checkpoint is read by ``tools/tf_bundle`` (numpy; TensorFlow is never
imported), the tree is the model's own in the Flax layout
(``convert.state_dict_to_flax``), and the filled tree goes back through
``convert.flax_to_state_dict``.  Kernel layouts match the Flax tree's by
construction; fc1's 1x1x1 conv kernel reshapes to the Dense kernel.

Usable as a library (:func:`load_reference_checkpoint`,
:func:`verify_mapping`) or a CLI::

    python -m x3d_tpu_torch.tools.import_tf_checkpoint \\
        --ckpt=/path/to/models/X3D-XS/model \\
        --config=x3d_tpu_torch/configs/kinetics/X3D_XS.yaml \\
        --output=/tmp/x3d_xs

``--output`` is a model folder: the tool writes ``<output>/checkpoints/
ckpt-0.pt`` (``train/checkpoint.CheckpointManager``, a fresh train state
at step 0), so ``InferenceEngine.from_checkpoint(cfg, output)``,
``tools/eval --model_folder`` and ``tools/predict --model_folder`` serve
the imported weights.  ``--verify_only`` reads the index alone (no
``.data`` file needed) and prints the mapping's counts.  Flags keep the
JAX tool's names; added: ``--device`` (cuda by default; ``cpu`` runs on
the CPU).  Prints one JSON line; exits 1 where the mapping has errors.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from typing import Dict, Optional, Tuple

import numpy as np

SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"

_BN_LEAF = {"gamma": ("params", "scale"), "beta": ("params", "bias"),
            "moving_mean": ("batch_stats", "mean"),
            "moving_variance": ("batch_stats", "var")}


def map_variable(name: str) -> Optional[Tuple[str, ...]]:
    """Reference variable path -> (collection, key, key, ...) in the Flax
    tree.

    Returns None for non-model variables (optimizer slots, counters).
    """
    if not name.endswith(SUFFIX):
        return None
    if "OPTIMIZER_SLOT" in name or name.startswith("optimizer/") or \
            name.startswith("save_counter"):
        return None
    path = name[: -len(SUFFIX)]
    parts = path.split("/")

    def bn(prefix: Tuple[str, ...], leaf: str):
        coll, key = _BN_LEAF[leaf]
        return (coll,) + prefix + ("norm", key)

    # stem
    if parts[0] == "conv1":
        if parts[1] == "bn":
            return bn(("conv_1", "bn"), parts[2])
        return ("params", "conv_1", parts[1], parts[2])

    # residual stages
    if parts[0] == "stages":
        stage = int(parts[1]) + 2                 # paper-style numbering
        assert parts[2] == "stage"
        m = re.match(r"layer_with_weights-(\d+)", parts[3])
        block = f"stage{stage}_block{int(m.group(1))}"
        rest = parts[4:]
        if rest[0] == "bn_r":
            return bn((block, "bn_r"), rest[1])
        if rest[0] == "residual":
            return ("params", block, "residual", rest[1])
        assert rest[0] == "bottleneck"
        inner = rest[1]
        if inner.startswith("bn_"):
            return bn((block, "bottleneck", inner), rest[2])
        if inner.startswith("se_fc"):
            return ("params", block, "bottleneck", "se", inner, rest[2])
        return ("params", block, "bottleneck", inner, rest[2])

    # head
    if parts[0] == "conv5":
        if parts[1] == "layer_with_weights-0":
            return ("params", "conv_5", parts[2])
        return bn(("bn_5",), parts[2])
    if parts[0] == "fc1":
        return ("params", "fc_1", parts[1])
    if parts[0] == "fc2":
        return ("params", "fc_2", parts[1])
    return None


def _get_in(tree: Dict, keys: Tuple[str, ...]):
    node = tree
    for k in keys:
        node = node[k]
    return node


def _set_in(tree: Dict, keys: Tuple[str, ...], value) -> None:
    _get_in(tree, keys[:-1])[keys[-1]] = value


def load_reference_checkpoint(ckpt_prefix: str, model, device=None) -> Dict:
    """Fill ``model`` (in place) from a reference TF checkpoint and return
    the filled Flax tree ``{params, batch_stats}`` (float32 numpy).

    Every model variable of the checkpoint must land on a leaf of the
    model's tree with the same number of values (reshaped where the shapes
    differ: fc1's conv kernel); a missing target, a size that differs or a
    checkpoint without model variables raises.  Leaves the checkpoint does
    not hold keep the model's values.  CRCs are checked as a pipeline on
    ``device`` does (default: the model's device).
    """
    import torch

    from x3d_tpu_torch import convert
    from x3d_tpu_torch.tools import tf_bundle

    if device is None:
        device = next(model.parameters()).device
    tree = convert.state_dict_to_flax(model.state_dict())
    loaded = 0
    with tf_bundle.load_checkpoint(ckpt_prefix, device) as reader:
        for name, _ in reader.list_variables():
            target = map_variable(name)
            if target is None:
                continue
            try:
                current = _get_in(tree, target)
            except KeyError:
                raise KeyError(f"{name}: no leaf {'/'.join(target)} in the "
                               "model") from None
            value = reader.get_tensor(name)
            if value.size != current.size:
                raise ValueError(f"{name}: {value.shape} in the checkpoint, "
                                 f"{current.shape} in the model")
            _set_in(tree, target, np.ascontiguousarray(
                value.reshape(current.shape), dtype=np.float32))
            loaded += 1
    if loaded == 0:
        raise ValueError(f"No model variables found in {ckpt_prefix}")
    state = convert.flax_to_state_dict(tree)
    with torch.no_grad():
        model.load_state_dict(state, strict=True)
    return tree


def verify_mapping(ckpt_prefix: str, model, device=None) -> Dict[str, int]:
    """Check that every checkpoint variable maps to an existing slot of the
    model's tree with as many values (works from the .index alone -- no
    .data needed): ``{"mapped", "skipped", "errors"}``, each error named on
    stderr."""
    from x3d_tpu_torch import convert
    from x3d_tpu_torch.tools import tf_bundle

    tree = convert.state_dict_to_flax(model.state_dict())
    stats = {"mapped": 0, "skipped": 0, "errors": 0}
    for name, shape in tf_bundle.list_variables(ckpt_prefix, device):
        target = map_variable(name)
        if target is None:
            stats["skipped"] += 1
            continue
        try:
            current = _get_in(tree, target)
        except KeyError:
            stats["errors"] += 1
            print(f"MISSING target {target} for {name}", file=sys.stderr)
            continue
        ours = tuple(current.shape)
        if ours != tuple(shape) and \
                int(np.prod(shape)) != int(np.prod(ours)):
            stats["errors"] += 1
            print(f"SHAPE mismatch {name}: ckpt {shape} vs ours {ours}",
                  file=sys.stderr)
            continue
        stats["mapped"] += 1
    return stats


def build_parser() -> argparse.ArgumentParser:
    from x3d_tpu_torch.tools.common import add_bool_flag

    p = argparse.ArgumentParser(
        prog="x3d_tpu_torch.tools.import_tf_checkpoint",
        description="Import a reference TF checkpoint into a port model "
                    "folder.")
    p.add_argument("--ckpt", required=True,
                   help="TF checkpoint prefix (e.g. .../model).")
    p.add_argument("--config", required=True, help="Variant config yaml.")
    p.add_argument("--output", default=None,
                   help="Model folder to write (checkpoints/ckpt-0.pt).")
    add_bool_flag(p, "verify_only", False,
                  "Only verify the name mapping (works without .data).")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu.")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import os

    import torch

    from x3d_tpu_torch import convert
    from x3d_tpu_torch.models import create_model
    from x3d_tpu_torch.tools.common import load_config
    from x3d_tpu_torch.train import create_train_state
    from x3d_tpu_torch.train.checkpoint import CheckpointManager
    from x3d_tpu_torch.utils import resolve_device

    cfg = load_config(args.config)
    device = resolve_device(args.device)
    # the import starts from the seeded initialisation, as the JAX tool's
    # does: a leaf the checkpoint lacks keeps a drawn value
    model = create_model(cfg, dtype=torch.float32, device=device,
                         init=not args.verify_only)
    stats = verify_mapping(args.ckpt, model, device)
    if args.verify_only or stats["errors"]:
        print(json.dumps(stats), flush=True)
        return 1 if stats["errors"] else 0
    tree = load_reference_checkpoint(args.ckpt, model, device)
    out = dict(stats, leaves=sum(1 for _ in convert._flatten(tree)))
    if args.output:
        mgr = CheckpointManager(os.path.join(args.output, "checkpoints"),
                                max_to_keep=0)
        mgr.save(0, create_train_state(cfg, model, steps_per_epoch=1))
        mgr.close()
        out["saved"] = os.path.join(mgr.directory, "ckpt-0.pt")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
