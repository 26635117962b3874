"""Weights from the seed, made on the device in one draw.

Every tensor of the reference's state dict (``reference/x3d.py``; the
program under test takes the same names and layouts) is a slice of one
uniform draw from a ``torch.Generator`` on the device, scaled by its kind:
conv and dense kernels glorot-uniform with Keras's fans, biases within
0.1 of 0, BatchNorm scales within 0.2 of 1, shifts and running means
within 0.1 of 0, running variances in [0.8, 1.25].  BatchNorm variables
away from their initial values put every BN's affine and, in eval, its
running statistics into the comparison.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference import x3d

# (low, high) of the uniform draw by the last part of a tensor's name
RANGES = {"bias": (-0.1, 0.1), "scale": (0.8, 1.2), "mean": (-0.1, 0.1),
          "var": (0.8, 1.25)}



def _glorot(name: str, shape) -> float:
    """The glorot-uniform limit of a kernel: fans (receptive field x in,
    receptive field x out), a depthwise kernel's in being 1."""
    if name.endswith("kernel"):             # (kt, kh, kw, 1, C)
        rf = math.prod(shape[:3])
        fan_in, fan_out = rf, rf * shape[4]
    else:                                   # (cout, cin[, kt, kh, kw])
        rf = math.prod(shape[2:]) if len(shape) > 2 else 1
        fan_in, fan_out = rf * shape[1], rf * shape[0]
    return math.sqrt(6.0 / (fan_in + fan_out))


def make(network: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The float32 state dict of the configuration's network, drawn from
    ``seed`` on ``device``."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in
                  x3d.X3D(x3d.plan(network)).state_dict().items()}
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        u = flat[at:at + n].view(shape)
        at += n
        kind = name.rsplit(".", 1)[-1]
        if kind in RANGES:
            lo, hi = RANGES[kind]
        else:
            hi = _glorot(name, shape)
            lo = -hi
        out[name] = u * (hi - lo) + lo
    return out
