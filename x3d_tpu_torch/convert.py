"""Weight bridge between the JAX package's Flax variables and the port.

A Flax tree ``{'params': {...}, 'batch_stats': {...}}`` of arrays maps to
the port's ``state_dict`` and back.  Module paths keep their Flax names, so
``params/stage2_block0/bottleneck/bn_a/norm/scale`` becomes the key
``stage2_block0.bottleneck.bn_a.norm.scale``.  Layouts:

=====================================  ==========  ========================
Flax leaf                              port leaf   port layout
=====================================  ==========  ========================
conv kernel (kt, kh, kw, Cin, Cout)    ``weight``  (Cout, Cin, kt, kh, kw)
1×1×1 conv kernel (1, 1, 1, Cin, Cout) ``weight``  (Cout, Cin)
depthwise kernel (kt, kh, kw, 1, C)    ``kernel``  unchanged
Dense kernel (in, out)                 ``weight``  (out, in)
bias, BN scale / bias / mean / var     same name   unchanged
=====================================  ==========  ========================

BN ``mean``/``var`` are ``batch_stats`` in Flax and buffers in the port.

:func:`train_state_to_flax` and :func:`train_state_from_flax` carry a whole
train state across -- parameters, BN statistics, the step and the
optimizer's slots -- as numpy trees; reading or writing the JAX package's
checkpoint directory with them is the caller's part (it needs ``orbax``,
which the port never imports).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_FULL_CONV = ("conv_s",)              # stem 1×3×3 conv
_DEPTHWISE = ("conv_t", "b")          # depthwise taps
_DENSE = ("fc_1", "fc_2")             # head fully connected layers
_STATS = ("mean", "var")              # BN running statistics


def _flatten(tree, prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def flax_to_state_dict(variables) -> Dict[str, torch.Tensor]:
    """Flax ``{'params', 'batch_stats'}`` tree -> the port's state_dict."""
    out = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            *mods, name = path
            arr = np.asarray(leaf)
            module = mods[-1] if mods else ""
            if name == "kernel" and module not in _DEPTHWISE:
                name = "weight"
                if module in _FULL_CONV:
                    arr = arr.transpose(4, 3, 0, 1, 2)
                elif module in _DENSE:
                    arr = arr.T
                else:                                   # 1×1×1 conv
                    arr = arr.reshape(arr.shape[-2], arr.shape[-1]).T
            out[".".join(mods + [name])] = torch.tensor(arr)
    return out


def state_dict_to_flax(state_dict) -> Dict[str, dict]:
    """The port's state_dict -> a Flax ``{'params', 'batch_stats'}`` tree of
    numpy arrays."""
    tree = {"params": {}, "batch_stats": {}}
    for key, t in state_dict.items():
        *mods, name = key.split(".")
        arr = t.detach().cpu().numpy()
        module = mods[-1] if mods else ""
        if name == "weight":
            name = "kernel"
            if module in _FULL_CONV:
                arr = arr.transpose(2, 3, 4, 1, 0)
            elif module in _DENSE:
                arr = arr.T
            else:
                arr = arr.T.reshape((1, 1, 1) + arr.T.shape)
        node = tree["batch_stats" if name in _STATS else "params"]
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(arr)
    return tree


# ------------------------------------------------------------ train states

_SLOTS = {"SGD": ("trace",), "Adam": ("mu", "nu")}
_TORCH_SLOT = {"trace": "momentum_buffer", "mu": "exp_avg",
               "nu": "exp_avg_sq"}


def _optimizer_kind(optimizer) -> str:
    kind = type(optimizer).__name__
    if kind not in _SLOTS:
        raise NotImplementedError(
            f"no bridge for the optimizer {kind}; SGD and Adam have one")
    return kind


def train_state_to_flax(state) -> Dict[str, object]:
    """A :class:`~x3d_tpu_torch.train.state.TrainState` as numpy trees in
    the JAX package's layout, so a state trained here continues there::

        {"step": int, "params": {...}, "batch_stats": {...},
         "opt_state": {"trace": {...}}                          # SGD
                    | {"count": int, "mu": {...}, "nu": {...}}} # Adam

    ``trace`` is optax's SGD momentum trace (torch's ``momentum_buffer``);
    ``mu``/``nu``/``count`` are optax's Adam moments and step count
    (``exp_avg``/``exp_avg_sq``/``step``).  Each slot tree has the shape of
    ``params``.  Slots the optimizer has not made yet (before its first
    step) are zeros, as optax initialises them.
    """
    kind = _optimizer_kind(state.optimizer)
    tree = state_dict_to_flax(state.model.state_dict())
    named = dict(state.model.named_parameters())
    slots, count = {}, 0
    for slot in _SLOTS[kind]:
        tensors = {}
        for name, p in named.items():
            held = state.optimizer.state.get(p, {})
            tensors[name] = held.get(_TORCH_SLOT[slot], torch.zeros_like(p))
            if "step" in held:
                count = int(held["step"])
        slots[slot] = state_dict_to_flax(tensors)["params"]
    if kind == "Adam":
        slots["count"] = count
    return {"step": int(state.step), "params": tree["params"],
            "batch_stats": tree["batch_stats"], "opt_state": slots}


def train_state_from_flax(tree, state):
    """Load the numpy trees of :func:`train_state_to_flax` (or the same
    trees taken from a JAX ``TrainState``) into ``state``, in place: the
    parameters, the BN statistics, the step and the optimizer's slots."""
    kind = _optimizer_kind(state.optimizer)
    state.model.load_state_dict(flax_to_state_dict(
        {"params": tree["params"], "batch_stats": tree["batch_stats"]}))
    state.step = int(tree["step"])
    opt = tree["opt_state"]
    held = {slot: flax_to_state_dict({"params": opt[slot]})
            for slot in _SLOTS[kind]}
    for name, p in state.model.named_parameters():
        slots = {_TORCH_SLOT[slot]: held[slot][name].to(p.device, p.dtype)
                 for slot in _SLOTS[kind]}
        if kind == "Adam":
            slots["step"] = torch.tensor(float(opt["count"]))
        state.optimizer.state[p] = slots
    return state
