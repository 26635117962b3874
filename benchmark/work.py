"""The benchmark's yardstick of work: operations and bytes from layer shapes.

Every conv and linear layer of the reference's architecture
(``reference/x3d.plan``) on a (clips, T, S, S, 3) input is one work item
a pass: ``dw`` for the depthwise convs, ``pw`` for the dense ones (every
1x1x1 conv, the stem's 1x3x3 conv, the Squeeze-Excite and head linears).
An item's least time is the larger of its bytes at the device's memory
bandwidth and its operations at the peak of its class (``PEAKS``), with
each input read once and each output written once.  A training pass adds
each layer's backward as one item: the input-gradient and the weight
gradient together (the stem's conv has no input gradient: its input is
data).  Activations are counted at the compute dtype's width, weights
and their gradients in float32, as the program keeps them; the
classifier computes in float32.

Operations are those ``torch.utils.flop_counter.FlopCounterMode`` counts
for the reference's convs and linear layers: two a multiply-add.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from benchmark.reference import x3d

# NVIDIA H100 SXM, NVIDIA's data sheet: HBM3 bandwidth, dense bf16 tensor
# cores, float32 off the tensor cores
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
PEAKS = {"dw": F32_FLOPS, "pw": BF16_FLOPS}


@dataclass(frozen=True)
class Item:
    cls: str          # "dw" or "pw"
    layer: str
    direction: str    # "fwd" or "bwd"
    flops: float
    bytes: float

    @property
    def least_s(self) -> float:
        return max(self.bytes / HBM_BYTES_S, self.flops / PEAKS[self.cls])


def _out(size: int, stride: int) -> int:
    return -(-size // stride)


def items(network: dict, clips: int, frames: int, size: int,
          train: bool, act_bytes: int = 2) -> List[Item]:
    """The work items of one pass over ``clips`` clips of ``frames`` x
    ``size``^2 pixels: the forward, and with ``train`` the backward."""
    p = x3d.plan(network)
    out: List[Item] = []
    e, f4 = act_bytes, 4

    def pw(layer, rows, cin, cout, x_elems=None, ea=e, dx=True):
        x_elems = rows * cin if x_elems is None else x_elems
        flops = 2.0 * rows * cin * cout
        w = cin * cout * f4
        out.append(Item("pw", layer, "fwd", flops,
                        x_elems * ea + w + rows * cout * ea))
        if train:
            # dW: read x, dy; write dW.  dx: read dy, W; write dx
            byt = x_elems * ea + rows * cout * ea + 2 * w
            if dx:
                byt += x_elems * ea
            out.append(Item("pw", layer, "bwd", flops * (2 if dx else 1),
                            byt))

    def dw(layer, n_in, n_out, c, taps):
        flops = 2.0 * n_out * c * taps
        k = taps * c * f4
        out.append(Item("dw", layer, "fwd", flops,
                        n_in * c * e + k + n_out * c * e))
        if train:
            # read x, dy, k; write dx, dk
            out.append(Item("dw", layer, "bwd", 2 * flops,
                            2 * n_in * c * e + n_out * c * e + 2 * k))

    h = _out(size, 2)
    pos = clips * frames
    # the stem's 1x3x3 conv, stride (1, 2, 2): an implicit GEMM of K = 27
    out_px = pos * h * h
    pw("conv_1.conv_s", out_px, 27, p.c1, x_elems=pos * size * size * 3,
       dx=False)
    dw("conv_1.conv_t", out_px, out_px, p.c1, p.temp_filter)
    for b in p.blocks:
        n_in = pos * h * h
        h = _out(h, b.stride)
        n = pos * h * h
        pw(b.name + ".a", n_in, b.cin, b.inner)
        dw(b.name + ".b", n_in, n, b.inner, 27)
        if b.se:
            pw(b.name + ".se_fc1", clips, b.inner, b.se)
            pw(b.name + ".se_fc2", clips, b.se, b.inner)
        pw(b.name + ".c", n, b.inner, b.cout)
        if b.cin != b.cout or b.stride != 1:
            pw(b.name + ".residual", n, b.cin, b.cout)
    pw("conv_5", pos * h * h, p.blocks[-1].cout, p.conv5)
    pw("fc_1", clips, p.conv5, x3d.HEAD_WIDTH)
    pw("fc_2", clips, x3d.HEAD_WIDTH, p.classes, ea=4)
    return out


def forward_flops(network: dict, clips: int, frames: int, size: int
                  ) -> float:
    """The forward's operations (two a multiply-add) over the convs and
    linear layers."""
    return sum(i.flops for i in items(network, clips, frames, size, False))


def least_seconds(network: dict, clips: int, frames: int, size: int,
                  train: bool, cls: str) -> float:
    """The least time of one pass's work of one class."""
    return sum(i.least_s for i in items(network, clips, frames, size, train)
               if i.cls == cls)
