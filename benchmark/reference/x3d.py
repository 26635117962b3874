"""X3D in plain PyTorch and float32: the benchmark's reference.

Written from the X3D paper (arXiv:2004.04730, Table 1 and section 3) and
the configuration files of fcogidi/X3D-tf (``configs/kinetics/X3D_*.yaml``):

* Stem: a 1x3x3 conv, stride (1, 2, 2), one pixel of spatial padding, then
  a depthwise temporal conv of ``C1_TEMP_FILTER`` taps, BN, ReLU.
* Four stages of bottleneck ResBlocks (base depths 1, 2, 5, 3 times
  ``DEPTH_FACTOR``, base widths 24, 48, 96, 192 times ``WIDTH_FACTOR``,
  inner width times ``BOTTLENECK_WIDTH_FACTOR``); a block is 1x1x1 conv,
  BN, ReLU, 3x3x3 depthwise conv (TF "SAME" padding, spatial stride 2 at a
  stage's first block), BN, Squeeze-Excite on every other block (width a
  sixteenth of the inner one), swish, 1x1x1 conv, BN; a strided 1x1x1
  projection and BN where the shape changes; the sum in float32, ReLU.
* Head: 1x1x1 conv to the last inner width, BN, ReLU, global average pool,
  a 2048-wide linear layer, ReLU, dropout, the classifier.  Eval averages
  the softmax over a video's views.

BatchNorm normalises a training batch by its biased variance and folds
the batch statistics into the running ones as ``m * running + (1 - m) *
batch``.  Parameter names and layouts are those of the benchmark's weight
files (``benchmark/weights.py``), so one state dict loads into both this
model and the program under test.

``low="fp8"`` is the control: where the configuration computes in bf16,
float8 e4m3 (per-tensor scale) -- every conv's and linear layer's input,
weight and output, every BN's, the SE's and swish's output, and their
gradients in the backward pass -- while BN statistics, the residual sum,
the classifier, softmax and loss stay float32, as the configuration
states.  ``low="bf16"`` rounds the same tensors to bfloat16: the
configuration's own precision, computed independently of the program.

Nothing here imports the program under test.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

HEAD_WIDTH = 2048
FP8_MAX = 448.0


def round_width(width: int, multiplier: float, min_width: int = 8,
                divisor: int = 8) -> int:
    """A channel count scaled and rounded to a multiple of ``divisor``,
    never under ``min_width`` nor under 90% of the scaled width."""
    if not multiplier:
        return width
    scaled = width * multiplier
    rounded = max(min_width, int(scaled + divisor / 2) // divisor * divisor)
    if rounded < 0.9 * scaled:
        rounded += divisor
    return int(rounded)


def round_repeats(repeats: int, multiplier: float) -> int:
    return int(math.ceil(multiplier * repeats)) if multiplier else repeats


@dataclass(frozen=True)
class Block:
    name: str
    cin: int
    inner: int
    cout: int
    stride: int
    se: int              # Squeeze-Excite width, 0 where the block has none


@dataclass(frozen=True)
class Plan:
    c1: int
    temp_filter: int
    blocks: Tuple[Block, ...]
    conv5: int
    classes: int
    dropout: float
    momentum: float
    eps: float


def plan(network: dict) -> Plan:
    """The architecture from a configuration's ``NETWORK`` group."""
    net = network
    factor = net.get("WIDTH_FACTOR", 1.0)
    c1_base = net.get("C1_CHANNELS", 12)
    if net.get("SCALE_RES2", False):
        c1, mult = round_width(c1_base, factor), 1
    else:
        c1, mult = round_width(c1_base, 2), 2
    base = c1_base * mult
    basis = [(1, base), (2, round_width(base, 2)), (5, round_width(base, 4)),
             (3, round_width(base, 8))]
    blocks, cin, g, inner = [], c1, 0, c1
    for si, (depth, width) in enumerate(basis):
        cout = round_width(width, factor)
        inner = int(cout * net["BOTTLENECK_WIDTH_FACTOR"])
        for bi in range(round_repeats(depth, net["DEPTH_FACTOR"])):
            blocks.append(Block(f"stage{si + 2}_block{bi}",
                                cin if bi == 0 else cout, inner, cout,
                                2 if bi == 0 else 1,
                                round_width(inner, 0.0625) if g % 2 == 0
                                else 0))
            g += 1
        cin = cout
    bn = net.get("BN", {})
    return Plan(c1, net.get("C1_TEMP_FILTER", 5), tuple(blocks), inner,
                net["NUM_CLASSES"], net.get("DROPOUT_RATE", 0.0),
                bn.get("MOMENTUM", 0.9), bn.get("EPS", 1e-5))


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 under a per-tensor scale (the largest magnitude at the
    format's largest value)."""
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


ROUND = {"fp8": _round_fp8, "bf16": _round_bf16}


class _Round(torch.autograd.Function):
    """Round in the forward pass, and the gradient in the backward."""

    @staticmethod
    def forward(ctx, x, low):
        ctx.low = low
        return ROUND[low](x)

    @staticmethod
    def backward(ctx, g):
        return ROUND[ctx.low](g), None


def quantize(x: torch.Tensor, low: Optional[str]) -> torch.Tensor:
    """x and its gradient rounded to ``low`` ("fp8" or "bf16"); or x."""
    return _Round.apply(x, low) if low else x


def same_pad(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF "SAME" padding (before, after) of one axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Vars(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))


class BN(nn.Module):
    def __init__(self, c: int, eps: float, momentum: float,
                 low: Optional[str] = None):
        super().__init__()
        self.eps, self.momentum, self.low = eps, momentum, low
        self.norm = Vars(c)
        self.fold = True       # False while a checkpoint recomputes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.norm
        if self.training:
            var, mean = torch.var_mean(x, dim=(0, 2, 3, 4), unbiased=False)
            if self.fold:
                with torch.no_grad():
                    m = self.momentum
                    n.mean.copy_(m * n.mean + (1 - m) * mean)
                    n.var.copy_(m * n.var + (1 - m) * var)
        else:
            mean, var = n.mean, n.var
        v = (1, -1, 1, 1, 1)
        mul = torch.rsqrt(var + self.eps) * n.scale
        return quantize(x * mul.view(v) + (n.bias - mean * mul).view(v),
                        self.low)


class Pointwise(nn.Module):
    """1x1x1 conv (weight (cout, cin)) on NCDHW, or a linear layer on
    (B, cin); spatial stride ``stride``."""

    def __init__(self, cin: int, cout: int, bias: bool = False,
                 stride: int = 1, low: Optional[str] = None):
        super().__init__()
        self.stride, self.low = stride, low
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = quantize(self.weight, self.low)
        x = quantize(x, self.low)
        if x.dim() == 2:
            return quantize(F.linear(x, w, self.bias), self.low)
        s = self.stride
        return quantize(F.conv3d(x, w[:, :, None, None, None], self.bias,
                                 stride=(1, s, s)), self.low)


class Depthwise(nn.Module):
    """Depthwise conv, taps ``kernel`` (kt, kh, kw, 1, C); TF "SAME"
    padding, or the explicit symmetric ``pad`` (t, h, w)."""

    def __init__(self, c: int, taps: Sequence[int], stride: int = 1,
                 pad: Optional[Sequence[int]] = None,
                 low: Optional[str] = None):
        super().__init__()
        self.taps, self.stride, self.pad, self.low = tuple(taps), stride, \
            pad, low
        self.kernel = nn.Parameter(torch.zeros(*taps, 1, c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kt, kh, kw = self.taps
        s = self.stride
        if self.pad is None:
            t0, t1 = same_pad(x.shape[2], kt, 1)
            h0, h1 = same_pad(x.shape[3], kh, s)
            w0, w1 = same_pad(x.shape[4], kw, s)
        else:
            (t0, h0, w0) = (t1, h1, w1) = self.pad
        x = F.pad(quantize(x, self.low), (w0, w1, h0, h1, t0, t1))
        w = quantize(self.kernel, self.low).permute(4, 3, 0, 1, 2)
        return quantize(F.conv3d(x, w, stride=(1, s, s), groups=x.shape[1]),
                        self.low)


class Stem(nn.Module):
    def __init__(self, p: Plan, low: Optional[str]):
        super().__init__()
        self.low = low
        self.conv_s = nn.Module()
        self.conv_s.weight = nn.Parameter(torch.zeros(p.c1, 3, 1, 3, 3))
        k = p.temp_filter
        self.conv_t = Depthwise(p.c1, (k, 1, 1), pad=(k // 2, 0, 0),
                                low=low)
        self.bn = BN(p.c1, p.eps, p.momentum, low)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = quantize(F.conv3d(quantize(x, self.low),
                              quantize(self.conv_s.weight, self.low),
                              stride=(1, 2, 2), padding=(0, 1, 1)), self.low)
        return torch.relu(self.bn(self.conv_t(x)))


class SE(nn.Module):
    def __init__(self, width: int, c: int, low: Optional[str]):
        super().__init__()
        self.low = low
        self.se_fc1 = Pointwise(c, width, bias=True, low=low)
        self.se_fc2 = Pointwise(width, c, bias=True, low=low)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.relu(self.se_fc1(x.mean(dim=(2, 3, 4))))
        gate = torch.sigmoid(self.se_fc2(s))[:, :, None, None, None]
        return quantize(x * gate, self.low)


class Bottleneck(nn.Module):
    def __init__(self, b: Block, p: Plan, low: Optional[str]):
        super().__init__()
        self.low = low
        self.a = Pointwise(b.cin, b.inner, low=low)
        self.bn_a = BN(b.inner, p.eps, p.momentum, low)
        self.b = Depthwise(b.inner, (3, 3, 3), b.stride, low=low)
        self.bn_b = BN(b.inner, p.eps, p.momentum, low)
        self.se = SE(b.se, b.inner, low) if b.se else None
        self.c = Pointwise(b.inner, b.cout, low=low)
        self.bn_c = BN(b.cout, p.eps, p.momentum, low)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn_b(self.b(torch.relu(self.bn_a(self.a(x)))))
        if self.se is not None:
            x = self.se(x)
        return self.bn_c(self.c(quantize(F.silu(x), self.low)))


class ResBlock(nn.Module):
    def __init__(self, b: Block, p: Plan, low: Optional[str]):
        super().__init__()
        self.bottleneck = Bottleneck(b, p, low)
        self.residual = self.bn_r = None
        if b.cin != b.cout or b.stride != 1:
            self.residual = Pointwise(b.cin, b.cout, stride=b.stride,
                                      low=low)
            self.bn_r = BN(b.cout, p.eps, p.momentum, low)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x if self.residual is None else self.bn_r(self.residual(x))
        return torch.relu(res + self.bottleneck(x))


@contextlib.contextmanager
def _recomputing(module: nn.Module):
    norms = [m for m in module.modules() if isinstance(m, BN)]
    for bn in norms:
        bn.fold = False
    try:
        yield
    finally:
        for bn in norms:
            bn.fold = True


def _checkpointed(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``module(x)`` keeping only x for the backward pass, which runs the
    forward again without folding BN statistics a second time."""
    return checkpoint(module, x, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _recomputing(module)))


class X3D(nn.Module):
    def __init__(self, p: Plan, low: Optional[str] = None):
        super().__init__()
        self.plan = p
        self.conv_1 = Stem(p, low)
        for b in p.blocks:
            self.add_module(b.name, ResBlock(b, p, low))
        self.conv_5 = Pointwise(p.blocks[-1].cout, p.conv5, low=low)
        self.bn_5 = BN(p.conv5, p.eps, p.momentum, low)
        self.fc_1 = Pointwise(p.conv5, HEAD_WIDTH, low=low)
        # the classifier computes in float32 (the configuration's precision)
        self.fc_2 = Pointwise(HEAD_WIDTH, p.classes, bias=True)

    def forward(self, video: torch.Tensor,
                keep: Optional[torch.Tensor] = None,
                checkpointed: bool = False) -> torch.Tensor:
        """Per-clip logits of (B, T, H, W, C) video.  ``keep``: the
        dropout's (B, 2048) boolean mask (training)."""
        run = _checkpointed if checkpointed and torch.is_grad_enabled() \
            else (lambda m, v: m(v))
        x = run(self.conv_1, video.permute(0, 4, 1, 2, 3))
        for b in self.plan.blocks:
            x = run(getattr(self, b.name), x)
        x = torch.relu(self.bn_5(self.conv_5(x))).mean(dim=(2, 3, 4))
        x = torch.relu(self.fc_1(x))
        if keep is not None:
            rate = self.plan.dropout
            x = torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
        return self.fc_2(x)

    @torch.no_grad()
    def probabilities(self, video: torch.Tensor, views: int) -> torch.Tensor:
        """Eval: per-video softmax probabilities averaged over its views,
        one video at a time."""
        out = [torch.softmax(self(video[i:i + views]), dim=-1).mean(0)
               for i in range(0, video.shape[0], views)]
        return torch.stack(out)


def weight_leaves(model: nn.Module) -> List[str]:
    """The names of the L2-regularised kernels: every conv and dense
    weight and depthwise kernel but the Squeeze-Excite's first layer's."""
    return [n for n, _ in model.named_parameters()
            if n.split(".")[-1] in ("weight", "kernel")
            and "se_fc1" not in n.split(".")]


def build(network: dict, state: Dict[str, torch.Tensor], device,
          low: Optional[str] = None) -> X3D:
    """A float32 reference model on ``device`` holding ``state``."""
    model = X3D(plan(network), low=low)
    model.load_state_dict({k: v.to(torch.float32) for k, v in state.items()},
                          strict=True)
    return model.to(device)
