"""The X3D network family in PyTorch: architecture plan and model.

Ported from the JAX package's ``x3d_tpu/models/x3d.py`` with its module
names (``conv_1``, ``stageN_blockM``, ``bn_* -> norm``), its parameter
shapes and its numerics, so that weights convert between the two
(``x3d_tpu_torch.convert``):

* Stem: (1,1) spatial pad + VALID 1×3×3 conv, stride (1,2,2) (a library
  conv) → k×1×1 depthwise conv (kernel K1) → BN → ReLU.
* Bottleneck: 1×1×1 conv → BN → ReLU → T×3×3 depthwise conv → BN → [SE] →
  swish → 1×1×1 conv → BN.  Stride-1 blocks run the fused segment
  (kernel K2: bn_a affine + ReLU + depthwise conv + per-sample sums, the SE
  pool taken from the sums, K3 its backward); in training their 1×1×1
  convs also emit BN sums (K5 for conv ``a``; K6 for conv ``c``, with bn_b's
  affine, the SE gate and swish applied as it loads), so every BN of the
  block takes its batch statistics from kernel sums.  The stride-2 stage
  entries run bn_a, ReLU and the depthwise conv (K1, K4 its backward) apart.
* SE on blocks with an even global index; ResBlock adds in float32 before
  the ReLU; the head pools, runs fc_1 (ReLU), dropout in training, and fc_2
  in float32, softmax in float32, and averages the probabilities over a
  video's views in eval mode.

Activations are NDHWC (B, T, H, W, C).  Parameters are float32; ``dtype``
sets the compute dtype.  In training mode (``model.train()``) BatchNorm
normalises with batch statistics, taken in float32 as E[x²] − E[x]², and
updates its running statistics in place as ``m·running + (1 − m)·batch``
with the biased variance, as the JAX package does; dropout draws from the
``generator`` passed to :meth:`X3D.forward`.  BatchNorm applies its affine
in float32 and rounds once to the compute dtype, as Flax's ``nn.BatchNorm``
does.  In eval mode with autograd off (serving, export) every BatchNorm
whose input a kernel writes -- K7's (conv ``c``, conv ``a`` at the stage
entries, the projections, conv_5), K2's (bn_b) and K1's (the stem, bn_b at
the stage entries) -- hands its coefficients, and the ReLU after it, to
that launch as its epilogue (``ops/epilogue.py``, :meth:`BatchNorm.after`):
the same numbers, without a pass of their own.

Per-replica (grouped) BN, ``TPU.SYNC_BN: False`` (``create_model(cfg,
bn_groups=g)``): the batch is split into ``g`` contiguous groups (sample b
in group ``b // (B/g)``), each normalised with its own statistics, and the
running statistics take the mean over the groups, as the JAX package's
``GroupedBatchNorm`` does; a grouped affine outside the kernels rounds its
coefficients to the compute dtype and computes in it, as that module does,
while the fused segments take per-sample float32 coefficient columns.
Across processes (``parallel.Mesh``): with ``SYNC_BN: True`` each
training-mode BatchNorm all-reduces its per-channel moments over the data
group (global statistics; the backward all-reduces their cotangents), and
with ``SYNC_BN: False`` each rank's batch is one group and the train step
averages the running statistics over the ranks.  With a model axis the
head's fc_1 is split by output columns and fc_2 by input rows over the
model group (``split_head``).

Rematerialisation (``remat``, the JAX package's modes): in a training step
with gradients, "block" recomputes each ResBlock's forward in the backward
pass and keeps only the block boundaries, "stage" each stage's
(``torch.utils.checkpoint``, non-reentrant), and "convs" keeps each
ResBlock's conv outputs and recomputes only its BN / ReLU / SE / swish
chains (a selective checkpoint whose policy saves the outputs of the
``x3d::`` ops, through which the kernels' forwards launch inside such a
region: K5, K2, K6 on the stride-1 blocks, K7 and K1 on the stage
entries).  A recompute takes the same batch statistics (the kernels and
plain versions are deterministic) and does not fold them into the running
statistics a second time; dropout sits in the head, outside every
recomputed region.

Time-folded layout (``time_fold``, ``fold_stages``: the JAX package's
options): the model takes them, resolves them and makes the JAX package's
two refusals, and then runs its one body for every layout.  On a TPU the
folded (B·T, 1, H, W, C) layout fills the batch-minor lanes at small
batches; on a GPU that tensor is the same memory as the NDHWC
(B, T, H, W, C) one, and each module would run on the (B, T, H, W, C)
view of it, so a folded body would launch the same kernels on the same
memory.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from x3d_tpu_torch import ops, utils
from x3d_tpu_torch.ops import depthwise, dw_fused, epilogue, library, pw_stats
from x3d_tpu_torch.ops.pointwise import pointwise_conv3d
from x3d_tpu_torch.parallel import mesh as parallel


@dataclass(frozen=True)
class BlockSpec:
    """Static description of one residual block."""
    in_channels: int
    inner_channels: int
    out_channels: int
    stride: int          # spatial stride of the depthwise conv (1 or 2)
    use_se: bool         # squeeze-excitation on this block (global pattern)
    se_width: int        # hidden width of the SE bottleneck


@dataclass(frozen=True)
class X3DArch:
    """Static architecture plan."""
    conv1_dim: int
    temp_filter: int                      # stem temporal kernel size
    stages: Tuple[Tuple[BlockSpec, ...], ...]
    conv5_dim: int                        # = last stage's inner width
    num_classes: int
    dropout_rate: float
    bn_momentum: float
    bn_eps: float
    num_views: int                        # eval-time clips averaged per video
    temp_kernel: int = 3                  # bottleneck temporal kernel size
    head_dim: int = 2048


def build_arch(cfg) -> X3DArch:
    """Expand the shared X3D template by the config's width/depth factors,
    including the SCALE_RES2 branch; SE sits on even global block indices."""
    net = cfg.NETWORK
    if net.SCALE_RES2:
        conv1_dim = utils.round_width(net.C1_CHANNELS, net.WIDTH_FACTOR)
        multiplier = 1
    else:
        conv1_dim = utils.round_width(net.C1_CHANNELS, 2)
        multiplier = 2

    base = net.C1_CHANNELS * multiplier
    block_basis = [
        (1, base),
        (2, utils.round_width(base, 2)),
        (5, utils.round_width(base, 4)),
        (3, utils.round_width(base, 8)),
    ]

    stages = []
    in_dim = conv1_dim
    global_index = 0
    inner_dim = conv1_dim
    for depth_base, width_base in block_basis:
        out_dim = utils.round_width(width_base, net.WIDTH_FACTOR)
        inner_dim = int(out_dim * net.BOTTLENECK_WIDTH_FACTOR)
        depth = utils.round_repeats(depth_base, net.DEPTH_FACTOR)
        blocks = []
        for i in range(depth):
            blocks.append(
                BlockSpec(
                    in_channels=in_dim if i == 0 else out_dim,
                    inner_channels=inner_dim,
                    out_channels=out_dim,
                    stride=2 if i == 0 else 1,
                    use_se=(global_index % 2 == 0),
                    se_width=utils.round_width(inner_dim, 0.0625),
                )
            )
            global_index += 1
        stages.append(tuple(blocks))
        in_dim = out_dim

    return X3DArch(
        conv1_dim=conv1_dim,
        temp_filter=net.C1_TEMP_FILTER,
        stages=tuple(stages),
        conv5_dim=inner_dim,
        num_classes=net.NUM_CLASSES,
        dropout_rate=net.DROPOUT_RATE,
        bn_momentum=net.BN.MOMENTUM,
        bn_eps=net.BN.EPS,
        num_views=cfg.TEST.NUM_TEMPORAL_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS,
    )


# ------------------------------------------------------------------ layers


def _glorot_uniform_(w: torch.Tensor, fan_in: int, fan_out: int,
                     generator: torch.Generator) -> None:
    """Keras/Flax glorot_uniform, with the fans of the Flax kernel shape
    (receptive field × in, receptive field × out)."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.uniform_(-limit, limit, generator=generator)


class Conv(nn.Module):
    """Full 3-D conv on NDHWC input (the stem's conv_s), a library conv.
    weight: (Cout, Cin, kt, kh, kw); explicit symmetric ``padding``."""

    def __init__(self, cin: int, cout: int, kernel_size, strides, padding,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.strides, self.padding, self.dtype = strides, padding, dtype
        self.weight = nn.Parameter(torch.empty(
            (cout, cin, *kernel_size), dtype=torch.float32, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        cout, cin = self.weight.shape[:2]
        rf = math.prod(self.weight.shape[2:])
        _glorot_uniform_(self.weight, rf * cin, rf * cout, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv3d(x.to(self.dtype).permute(0, 4, 1, 2, 3),
                     self.weight.to(self.dtype), stride=self.strides,
                     padding=self.padding)
        return y.permute(0, 2, 3, 4, 1).contiguous()


class DepthwiseConv3D(nn.Module):
    """Depthwise conv through kernel K1; taps ``kernel`` (kt, kh, kw, 1, C)."""

    def __init__(self, channels: int, kernel_size, strides=(1, 1, 1),
                 padding="SAME", dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        self.strides, self.padding, self.dtype = strides, padding, dtype
        self.kernel = nn.Parameter(torch.empty(
            (*kernel_size, 1, channels), dtype=torch.float32, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        rf = math.prod(self.kernel.shape[:3])
        _glorot_uniform_(self.kernel, rf, rf * self.kernel.shape[4],
                         generator)

    def forward(self, x: torch.Tensor, bn: Optional[Tuple] = None,
                relu: bool = False) -> torch.Tensor:
        """``bn``: a BatchNorm's eval (mul, add) and ``relu``, applied as
        K1's epilogue (:meth:`BatchNorm.after`)."""
        return depthwise.depthwise(x.to(self.dtype), self.kernel,
                                   self.strides, self.padding, *(bn or ()),
                                   relu=relu)


class Pointwise(nn.Module):
    """1×1×1 conv as a matmul over C; weight (Cout, Cin), optional bias."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype,
                 bias: bool = False, strides=(1, 1, 1), device=None):
        super().__init__()
        self.strides, self.dtype = strides, dtype
        self.weight = nn.Parameter(
            torch.empty((cout, cin), dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.empty(
            (cout,), dtype=torch.float32, device=device)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        cout, cin = self.weight.shape
        _glorot_uniform_(self.weight, cin, cout, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, bn: Optional[Tuple] = None,
                relu: bool = False) -> torch.Tensor:
        """``bn``: a BatchNorm's eval (mul, add) and ``relu``, applied as
        K7's epilogue (:meth:`BatchNorm.after`)."""
        return pointwise_conv3d(x.to(self.dtype), self.weight, self.strides,
                                self.bias, *(bn or ()), relu=relu)


class _NormVars(nn.Module):
    """BatchNorm variables under Flax's names: params ``scale``/``bias``,
    running statistics ``mean``/``var`` (buffers)."""

    def __init__(self, c: int, device=None):
        super().__init__()
        kw = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(torch.ones(c, **kw))
        self.bias = nn.Parameter(torch.zeros(c, **kw))
        self.register_buffer("mean", torch.zeros(c, **kw))
        self.register_buffer("var", torch.ones(c, **kw))


def batch_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, var) of x over every axis but the last, in float32
    and in one pass: var = E[x²] − E[x]², the form the kernels' sums reduce
    to (``x3d_tpu/models/x3d.py:198-204``)."""
    mean, msq = moments(x)
    return mean, msq - mean * mean


def moments(x: torch.Tensor, groups: int = 1
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel float32 (E[x], E[x²]) of x over every axis but the last:
    (C,) each, or (groups, C) over ``groups`` contiguous slices of the
    batch."""
    x32 = x.to(torch.float32)
    if groups > 1:
        x32 = x32.reshape(groups, _group_size(x.shape[0], groups), -1,
                          x.shape[-1])
        return x32.mean(dim=(1, 2)), (x32 * x32).mean(dim=(1, 2))
    dims = tuple(range(x.dim() - 1))
    return x32.mean(dim=dims), (x32 * x32).mean(dim=dims)


def moments_from_sums(p: torch.Tensor, s2: torch.Tensor, n: int,
                      groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(E[y], E[y²]) from a kernel's (C, B) per-sample sums of y and y²;
    ``n`` is the element count per channel over the batch.  (C,) each, or
    (groups, C) from the groups' columns, as ``_stats_from_sums`` takes
    them (``x3d_tpu/models/x3d.py:433-455``)."""
    if groups > 1:
        C, B = p.shape
        b = _group_size(B, groups)
        pg = p.reshape(C, groups, b).sum(-1).t()
        sg = s2.reshape(C, groups, b).sum(-1).t()
        return pg / (n // groups), sg / (n // groups)
    return p.sum(dim=1) / n, s2.sum(dim=1) / n


def _group_size(batch: int, groups: int) -> int:
    if batch % groups:
        raise ValueError(f"batch {batch} not divisible by {groups} BN "
                         "groups")
    return batch // groups


def columns(v: torch.Tensor, batch: int) -> torch.Tensor:
    """(C, B) float32 per-sample coefficient columns from a (C,) vector
    (every column the same) or from (groups, C) rows (a group's samples
    take its row), as ``cb_cols`` builds them
    (``x3d_tpu/models/x3d.py:510-527``)."""
    if v.dim() == 1:
        return v[:, None].expand(v.shape[0], batch)
    return v.t().repeat_interleave(_group_size(batch, v.shape[0]), dim=1)


def grouped_affine(x: torch.Tensor, mul: torch.Tensor, add: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """x·mul + add with (groups, C) coefficients over contiguous slices of
    the batch, rounded as ``GroupedBatchNorm`` applies them
    (``x3d_tpu/models/x3d.py:211-214``): x, mul and add each in ``dtype``,
    the product and the sum in it."""
    g = mul.shape[0]
    xg = x.reshape(g, _group_size(x.shape[0], g), *x.shape[1:]).to(dtype)
    shape = (g,) + (1,) * (x.dim() - 1) + (x.shape[-1],)
    y = xg * mul.to(dtype).view(shape) + add.to(dtype).view(shape)
    return y.reshape(x.shape)


class _Affine(torch.autograd.Function):
    """x·mul + add over the last axis of a low-precision x, (C,) float32
    coefficients: one pass that computes in float32 and rounds once to x's
    dtype; backward dx = g·mul likewise, dmul = Σ g·x and dadd = Σ g summed
    in float32."""

    @staticmethod
    def forward(ctx, x, mul, add):
        ctx.save_for_backward(x, mul)
        return epilogue.reference(x, mul, add)

    @staticmethod
    def backward(ctx, g):
        x, mul = ctx.saved_tensors
        dims = tuple(range(g.dim() - 1))
        dx = dmul = dadd = None
        if ctx.needs_input_grad[0]:
            dx = torch.mul(g, mul, out=torch.empty_like(g))
        if ctx.needs_input_grad[1]:
            dmul = (g * x).sum(dims, dtype=torch.float32)
        if ctx.needs_input_grad[2]:
            dadd = g.sum(dims, dtype=torch.float32)
        return dx, dmul, dadd


def affine(x: torch.Tensor, mul: torch.Tensor, add: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """x·mul + add with (C,) float32 coefficients, in float32, rounded once
    to ``dtype``, as Flax's ``nn.BatchNorm`` applies its affine (on a
    float32 x: a product and a sum)."""
    if x.dtype == torch.float32:
        return epilogue.reference(x, mul, add).to(dtype)
    return _Affine.apply(x, mul, add).to(dtype)


class BatchNorm(nn.Module):
    """BatchNorm as normalise coefficients: mul = rsqrt(var + eps) * scale,
    add = bias - mean * mul (float32), applied in float32 and rounded once
    to the compute dtype (:func:`affine`).  Eval
    mode uses the running statistics; training mode the batch's, and it
    updates the running statistics in place.  Its variables live under
    ``<name>.norm``, as Flax's ``nn.BatchNorm`` child is named.

    ``groups`` > 1: per-replica statistics over contiguous slices of the
    batch, the running statistics updated with their mean, applied by
    :func:`grouped_affine`.  ``sync`` (a ``parallel.Mesh``): the moments
    are averaged over its data group before they are used (every rank
    holds an equal batch), so the statistics are the global batch's."""

    def __init__(self, c: int, eps: float, momentum: float,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.eps, self.momentum, self.dtype = eps, momentum, dtype
        self.groups = 1
        self.sync: Optional[parallel.Mesh] = None
        self.norm = _NormVars(c, device)
        # set while a remat region recomputes its forward (_recomputing):
        # the batch statistics were folded in by the first forward
        self.recomputing = False

    def coefs(self) -> Tuple[torch.Tensor, torch.Tensor]:
        n = self.norm
        mul = torch.rsqrt(n.var + self.eps) * n.scale
        return mul, n.bias - n.mean * mul

    def stats(self, mean: torch.Tensor, msq: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, var) from this rank's moments (E[x], E[x²]), averaged
        over the data group first where the statistics are synced: one
        all-reduce of both, whose backward all-reduces their
        cotangents."""
        if self.sync is not None:
            both = parallel.all_reduce_sum(torch.stack([mean, msq]),
                                           self.sync.data_group)
            both = both / self.sync.data
            mean, msq = both[0], both[1]
        return mean, msq - mean * mean

    def stats_from_sums(self, p: torch.Tensor, s2: torch.Tensor, n: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batch (mean, var) from a kernel's (C, B) per-sample sums."""
        return self.stats(*moments_from_sums(p, s2, n, self.groups))

    def batch_coefs(self, mean: torch.Tensor, var: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training: coefficients from batch statistics ((C,) or (groups,
        C)), after folding them -- their mean over the groups -- into the
        running ones (running = m·running + (1 − m)·batch) unless a remat
        region is recomputing its forward."""
        n, m = self.norm, self.momentum
        if not self.recomputing:
            with torch.no_grad():
                bm, bv = (mean, var) if mean.dim() == 1 \
                    else (mean.mean(0), var.mean(0))
                n.mean.copy_(m * n.mean + (1 - m) * bm)
                n.var.copy_(m * n.var + (1 - m) * bv)
        mul = torch.rsqrt(var + self.eps) * n.scale
        return mul, n.bias - mean * mul

    def apply_coefs(self, x: torch.Tensor, mul: torch.Tensor,
                    add: torch.Tensor) -> torch.Tensor:
        if mul.dim() == 1:
            return affine(x, mul, add, self.dtype)
        return grouped_affine(x, mul, add, self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul, add = self.batch_coefs(*self.stats(*moments(x, self.groups))) \
            if self.training else self.coefs()
        return self.apply_coefs(x, mul, add)

    def folds(self, conv: Optional[nn.Module] = None) -> bool:
        """Whether this BatchNorm rides the launch of the kernel that
        writes its input (``conv``'s, where the model calls it as a
        module): eval mode with autograd off (the epilogue has no
        backward), and no forward hook on either module, nor one on every
        module, that waits for the output it sees unfused (the debug
        dump's, ``train/debug.py``; a feature extractor's on the conv)."""
        return not self.training and not torch.is_grad_enabled() \
            and not _hooked(self, *(() if conv is None else (conv,)))

    def after(self, conv: nn.Module, x: torch.Tensor,
              relu: bool = False) -> torch.Tensor:
        """This BatchNorm (then a ReLU where asked) on ``conv(x)``: where it
        :meth:`folds`, as the epilogue of the conv's launch (K7 or K1; on
        the CPU or within ``ops.plain_versions()`` their plain versions,
        the same numbers)."""
        if self.folds(conv):
            return conv(x, self.coefs(), relu)
        y = self(conv(x))
        return torch.relu(y) if relu else y


def _hooked(*modules: nn.Module) -> bool:
    """Whether a forward hook or pre-hook is registered on any of
    ``modules`` or on every module (``register_module_forward_hook``)."""
    every = nn.modules.module
    return bool(every._global_forward_hooks
                or every._global_forward_pre_hooks) or any(
        m._forward_hooks or m._forward_pre_hooks for m in modules)


class Stem(nn.Module):
    """Channelwise-separable spatiotemporal stem."""

    def __init__(self, in_channels: int, out_channels: int, temp_filter: int,
                 bn_eps: float, bn_momentum: float, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.dtype = dtype
        # (1,1) spatial pad + VALID conv: not SAME, which would pad (0,1)
        self.conv_s = Conv(in_channels, out_channels, (1, 3, 3), (1, 2, 2),
                           (0, 1, 1), dtype, device)
        k = temp_filter
        self.conv_t = DepthwiseConv3D(
            out_channels, (k, 1, 1), (1, 1, 1),
            ((k // 2, k // 2), (0, 0), (0, 0)), dtype, device)
        self.bn = BatchNorm(out_channels, bn_eps, bn_momentum, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn.after(self.conv_t, self.conv_s(x.to(self.dtype)),
                             relu=True)


class SqueezeExcite(nn.Module):
    """Global pool → 1×1×1 conv (bias) → ReLU → 1×1×1 conv (bias) →
    float32 sigmoid gate."""

    def __init__(self, width: int, channels: int, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.se_fc1 = Pointwise(channels, width, dtype, bias=True,
                                device=device)
        self.se_fc2 = Pointwise(width, channels, dtype, bias=True,
                                device=device)

    def gate(self, pooled: torch.Tensor) -> torch.Tensor:
        """The (B, C) float32 gate from the (B, C) float32 pool."""
        s = torch.relu(self.se_fc1(pooled.to(self.dtype)))
        return torch.sigmoid(self.se_fc2(s).to(torch.float32))

    def forward(self, x: torch.Tensor,
                pooled: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, T, H, W, C); ``pooled``: the (B, C) float32 mean of x over
        (T, H, W) where the caller already has it."""
        if pooled is None:
            pooled = x.to(torch.float32).mean(dim=(1, 2, 3))
        return x * self.gate(pooled).to(x.dtype)[:, None, None, None, :]


class Bottleneck(nn.Module):
    """1×1×1 → T×3×3 depthwise → [SE] → swish → 1×1×1, BN after each conv."""

    def __init__(self, spec: BlockSpec, temp_kernel: int, bn_eps: float,
                 bn_momentum: float, dtype: torch.dtype, device=None):
        super().__init__()
        self.spec, self.dtype = spec, dtype
        C = spec.inner_channels
        bn = lambda c: BatchNorm(c, bn_eps, bn_momentum, dtype,  # noqa: E731
                                 device)
        self.a = Pointwise(spec.in_channels, C, dtype, device=device)
        self.bn_a = bn(C)
        self.b = DepthwiseConv3D(C, (temp_kernel, 3, 3),
                                 (1, spec.stride, spec.stride), "SAME",
                                 dtype, device)
        self.bn_b = bn(C)
        self.se = SqueezeExcite(spec.se_width, C, dtype, device) \
            if spec.use_se else None
        self.c = Pointwise(C, spec.out_channels, dtype, device=device)
        self.bn_c = bn(spec.out_channels)

    def _fused_segment(self, out: torch.Tensor) -> torch.Tensor:
        """Stride 1, eval: bn_a affine + ReLU + depthwise conv + per-sample
        sums in one kernel (K2), bn_b its epilogue where it folds
        (:meth:`BatchNorm.folds`); the SE pool comes from the sums."""
        B, T, H, W, C = out.shape
        mul_a, add_a = self.bn_a.coefs()
        a_cb = mul_a[:, None].expand(C, B)
        b_cb = add_a[:, None].expand(C, B)
        mul_b, add_b = self.bn_b.coefs()
        if self.bn_b.folds():
            out, p, _ = dw_fused.segment(out, a_cb, b_cb, self.b.kernel,
                                         mul_b, add_b)
        else:
            y, p, _ = dw_fused.segment(out, a_cb, b_cb, self.b.kernel)
            out = affine(y, mul_b, add_b, self.dtype)
        if self.se is not None:
            # mean of bn_b(y) over (T, H, W) = mul * mean(y) + add
            pooled = mul_b[:, None] * (p / (T * H * W)) + add_b[:, None]
            out = self.se(out, pooled=pooled.t())
        return out

    def _segment(self, x: torch.Tensor) -> torch.Tensor:
        """Stride 2, from the block's input: conv ``a`` (K7), bn_a and ReLU,
        the depthwise conv (K1) and bn_b apart (each BatchNorm its conv's
        epilogue where it folds)."""
        out = self.bn_b.after(self.b, self.bn_a.after(self.a, x, relu=True))
        if self.se is not None:
            out = self.se(out)
        return out

    def _fused_train(self, x: torch.Tensor) -> torch.Tensor:
        """Stride 1, training (``x3d_tpu/models/x3d.py:478-668``, segment
        "pallas" with the pointwise "mxu_seg" convs): K5 gives conv ``a``
        and bn_a's sums, K2/K3 the segment and bn_b's sums, the SE gate
        comes from ``p`` and is folded into bn_b's coefficient columns, and
        K6 runs swish and conv ``c`` and gives bn_c's sums.  With grouped
        statistics every BN's coefficients are (groups, C) rows, and the
        kernels take them as per-sample columns."""
        out, p_a, s2_a = pw_stats.conv_stats(x.to(self.dtype), self.a.weight)
        B, T, H, W, C = out.shape
        n = B * T * H * W
        mul_a, add_a = self.bn_a.batch_coefs(
            *self.bn_a.stats_from_sums(p_a, s2_a, n))
        y, p, s2 = dw_fused.segment(out, columns(mul_a, B),
                                    columns(add_a, B), self.b.kernel)
        mul_b, add_b = self.bn_b.batch_coefs(
            *self.bn_b.stats_from_sums(p, s2, n))
        a_cb, o_cb = columns(mul_b, B), columns(add_b, B)
        if self.se is not None:
            # (y*m + o)*s == y*(m*s) + o*s: the gate rides the columns
            gate = self.se.gate((a_cb * (p / (T * H * W)) + o_cb).t()).t()
            a_cb, o_cb = a_cb * gate, o_cb * gate
        z, p_c, s2_c = pw_stats.act_conv_stats(y, a_cb, o_cb, self.c.weight)
        mul_c, add_c = self.bn_c.batch_coefs(
            *self.bn_c.stats_from_sums(p_c, s2_c, n))
        return self.bn_c.apply_coefs(z, mul_c, add_c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.spec.stride == 1:
            return self._fused_train(x)
        x = x.to(self.dtype)
        out = self._fused_segment(self.a(x)) if self.spec.stride == 1 \
            else self._segment(x)
        return self.bn_c.after(self.c, F.silu(out))


class ResBlock(nn.Module):
    """Residual wrapper with a projection shortcut (strided 1×1×1 conv + BN)
    when the shape changes; the add runs in float32, before the ReLU."""

    def __init__(self, spec: BlockSpec, temp_kernel: int, bn_eps: float,
                 bn_momentum: float, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.bottleneck = Bottleneck(spec, temp_kernel, bn_eps, bn_momentum,
                                     dtype, device)
        self.residual = self.bn_r = None
        if spec.in_channels != spec.out_channels or spec.stride != 1:
            self.residual = Pointwise(
                spec.in_channels, spec.out_channels, dtype,
                strides=(1, spec.stride, spec.stride), device=device)
            self.bn_r = BatchNorm(spec.out_channels, bn_eps, bn_momentum,
                                  dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bottleneck(x)
        res = x if self.residual is None else \
            self.bn_r.after(self.residual, x.to(self.dtype))
        return torch.relu(res.to(torch.float32) + out.to(torch.float32))


def remat_mode(remat) -> str:
    """The remat setting as one of "off", "block", "stage", "convs":
    False/None and True are aliases of "off" and "block"; any other value
    raises ValueError, as ``x3d_tpu/models/x3d.py:800-804`` does."""
    mode = {False: "off", True: "block", None: "off"}.get(remat, remat)
    if mode not in ("off", "block", "stage", "convs"):
        raise ValueError(f"remat mode {remat!r}")
    return mode


def resolve_time_fold(time_fold, batch: int, temp: int,
                      train: bool = False) -> bool:
    """Whether a call on a (batch, temp, ...) input runs time-folded
    (``x3d_tpu/models/x3d.py:411-430``): False/True pass through; an int N
    folds training-mode calls with batch <= N; "auto" folds nothing here,
    as the JAX package resolves it on any backend but a TPU (it folds
    training calls whose batch underfills a TPU's 128 lanes)."""
    if time_fold == "auto":
        return False
    if isinstance(time_fold, int) and not isinstance(time_fold, bool):
        return train and batch <= time_fold
    return bool(time_fold)


@contextlib.contextmanager
def _recomputing(modules: Sequence[nn.Module]):
    """While a remat region recomputes its forward: its BatchNorms take the
    batch statistics without folding them into the running ones again."""
    norms = [m for mod in modules for m in mod.modules()
             if isinstance(m, BatchNorm)]
    for bn in norms:
        bn.recomputing = True
    try:
        yield
    finally:
        for bn in norms:
            bn.recomputing = False


def _run_blocks(blocks: Sequence[nn.Module], x: torch.Tensor
                ) -> torch.Tensor:
    for block in blocks:
        x = block(x)
    return x


def _remat(blocks: Sequence[nn.Module], x: torch.Tensor) -> torch.Tensor:
    """Run ``blocks`` keeping only their input for the backward pass, which
    recomputes their forward.  No random numbers are drawn inside, so no
    RNG state is kept."""
    return checkpoint(_run_blocks, blocks, x, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _recomputing(blocks)))


def _keep_convs(ctx, func, *args, **kwargs) -> CheckpointPolicy:
    """The "convs" policy: keep the kernels' outputs (the ``x3d::`` ops),
    recompute everything else."""
    return CheckpointPolicy.MUST_SAVE if func in library.OPS \
        else CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def _entered(*contexts):
    with contextlib.ExitStack() as stack:
        for c in contexts:
            stack.enter_context(c)
        yield


def _remat_convs(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Run ``block`` keeping its input and its kernels' outputs for the
    backward pass, which recomputes the rest of its forward and takes the
    kept outputs where the recompute calls the same ops again (a selective
    checkpoint; the JAX package's ``save_only_these_names("x3d_conv")``).
    The kernels launch through their ``x3d::`` ops in both passes
    (``ops.library_calls``), in the same order, which the checkpoint's
    cache is keyed by; the recompute folds no BN statistics.  Within
    ``ops.plain_versions()`` no op is called, so nothing is kept and the
    convs are recomputed: that path decides values, not memory."""
    def contexts():
        save, again = create_selective_checkpoint_contexts(_keep_convs)
        return (_entered(save, ops.library_calls()),
                _entered(again, ops.library_calls(), _recomputing([block])))

    return checkpoint(block, x, use_reentrant=False,
                      preserve_rng_state=False, context_fn=contexts)


class X3D(nn.Module):
    """The full X3D network.

    ``forward`` returns float32 softmax probabilities, in eval mode averaged
    over each video's views (the batch is videos × views clips), or with
    ``return_logits=True`` the per-clip logits.  ``remat`` (see
    :func:`remat_mode`) sets what a training step with gradients recomputes
    in its backward pass.  ``time_fold`` (False, True, "auto" or an int
    threshold, :func:`resolve_time_fold`) and ``fold_stages`` (0..4) are
    the JAX package's layout options: checked as it checks them, and
    computed by the one body (module docstring).  ``remat``, ``time_fold``
    and ``fold_stages`` may be reassigned between calls.
    """

    def __init__(self, arch: X3DArch, dtype: torch.dtype = torch.bfloat16,
                 in_channels: int = 3, device=None, remat=False,
                 time_fold=False, fold_stages: int = 4):
        super().__init__()
        self.arch, self.dtype = arch, dtype
        self.remat = remat_mode(remat)
        self.time_fold, self.fold_stages = time_fold, fold_stages
        eps, m = arch.bn_eps, arch.bn_momentum
        self.conv_1 = Stem(in_channels, arch.conv1_dim, arch.temp_filter, eps,
                           m, dtype, device)
        self.stage_names = []
        for si, blocks in enumerate(arch.stages):
            self.stage_names.append([])
            for bi, spec in enumerate(blocks):
                # stage numbering starts at 2, as in the paper
                name = f"stage{si + 2}_block{bi}"
                self.add_module(name, ResBlock(spec, arch.temp_kernel, eps,
                                               m, dtype, device))
                self.stage_names[-1].append(name)
        self.conv_5 = Pointwise(arch.stages[-1][-1].out_channels,
                                arch.conv5_dim, dtype, device=device)
        self.bn_5 = BatchNorm(arch.conv5_dim, eps, m, dtype, device)
        # the head's dense layers: the same product as a 1×1×1 conv
        self.fc_1 = Pointwise(arch.conv5_dim, arch.head_dim, dtype,
                              device=device)
        self.fc_2 = Pointwise(arch.head_dim, arch.num_classes, torch.float32,
                              bias=True, device=device)
        self.mesh: Optional[parallel.Mesh] = None
        self.sync_bn = True
        # name -> dim of the parameters split over the model group
        self.head_split = {}

    def set_parallel(self, mesh: Optional[parallel.Mesh], bn_groups: int = 1,
                     sync_bn: bool = True) -> None:
        """Per-replica BN groups in this process, and the mesh: with
        ``sync_bn`` every BatchNorm averages its moments over the data
        group (where the mesh has a process group); without it each rank's
        batch is its own group.  A model axis splits the head
        (:meth:`split_head`)."""
        self.mesh, self.sync_bn = mesh, sync_bn
        sync = mesh if mesh is not None and mesh.distributed and sync_bn \
            else None
        for bn in self.modules():
            if isinstance(bn, BatchNorm):
                bn.groups, bn.sync = bn_groups, sync
        if mesh is not None and mesh.model > 1:
            self.split_head(mesh)

    def split_head(self, mesh: parallel.Mesh) -> None:
        """Keep this model rank's shard of the head: fc_1's output columns
        (rows of its (2048, C) weight) and fc_2's input rows (columns of
        its (classes, 2048) weight), ``_param_spec``'s split
        (``x3d_tpu/parallel/mesh.py:66-72``).  A state dict holding the
        full tensors loads into the shards (:meth:`_cut_full_head`), so
        checkpoints hold full tensors on every mesh."""
        if self.arch.head_dim % mesh.model:
            raise ValueError(f"head width {self.arch.head_dim} not divisible "
                             f"by the model axis {mesh.model}")
        self.head_split = {"fc_1.weight": 0, "fc_2.weight": 1}
        with torch.no_grad():
            for name, dim in self.head_split.items():
                layer = getattr(self, name.split(".")[0])
                layer.weight = nn.Parameter(
                    parallel.cut_split(layer.weight, dim, mesh))
        self._register_load_state_dict_pre_hook(self._cut_full_head)

    def _cut_full_head(self, state_dict, prefix, *args) -> None:
        for name, dim in self.head_split.items():
            t = state_dict.get(prefix + name)
            if t is not None and t.shape[dim] == self.arch.head_dim:
                state_dict[prefix + name] = parallel.cut_split(t, dim,
                                                               self.mesh)

    def _check_fold(self, x: torch.Tensor) -> None:
        """The JAX package's two refusals of the layout options
        (``x3d_tpu/models/x3d.py:790-794``, ``:813-814``)."""
        B, T = x.shape[0], x.shape[1]
        fold = resolve_time_fold(self.time_fold, B, T, self.training)
        groups = self.conv_1.bn.groups
        if fold and T > 1 and groups > 1 and B % groups:
            raise ValueError(
                f"time_fold needs batch {B} divisible by bn_groups "
                f"{groups} (grouped statistics must not split clips)")
        if not 0 <= self.fold_stages <= 4:
            raise ValueError(f"fold_stages {self.fold_stages!r} not in 0..4")

    def forward(self, x: torch.Tensor, return_logits: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` (on x's device) draws the head's dropout mask in
        training mode; it is required there when the dropout rate is > 0."""
        arch = self.arch
        drop = self.training and arch.dropout_rate > 0
        if drop and generator is None:
            raise ValueError("training with dropout needs a torch.Generator "
                             "for the dropout mask")
        self._check_fold(x)
        x = self.conv_1(x)
        remat = self.remat if self.training and torch.is_grad_enabled() \
            else "off"
        for names in self.stage_names:
            blocks = [getattr(self, name) for name in names]
            if remat == "off":
                x = _run_blocks(blocks, x)
            elif remat == "stage":
                x = _remat(blocks, x)
            else:
                run = _remat_convs if remat == "convs" \
                    else lambda b, v: _remat([b], v)
                for block in blocks:
                    x = run(block, x)
        x = self.bn_5.after(self.conv_5, x.to(self.dtype), relu=True)
        x = x.to(torch.float32).mean(dim=(1, 2, 3)).to(self.dtype)
        group = self.mesh.model_group if self.head_split else None
        x = torch.relu(self.fc_1(parallel.copy_to_model(x, group)))
        if drop:
            # the mask over the full width from one seed on every model
            # rank, then this rank's columns: a split head draws the same
            # mask as the whole one
            keep = 1.0 - arch.dropout_rate
            mask = torch.rand((x.shape[0], arch.head_dim),
                              generator=generator, device=x.device) < keep
            if group is not None:
                w = x.shape[1]
                mask = mask.narrow(1, self.mesh.model_rank * w, w)
            x = torch.where(mask, x / keep, torch.zeros_like(x))
        if group is None:
            logits = self.fc_2(x.to(torch.float32))
        else:
            # the partial logits of this rank's rows, summed over the model
            # group in one all-reduce; the bias added once, after it
            fc = self.fc_2
            logits = parallel.reduce_from_model(pointwise_conv3d(
                x.to(torch.float32), fc.weight, fc.strides), group) + fc.bias
        if return_logits:
            return logits
        probs = torch.softmax(logits, dim=-1)
        if not self.training and arch.num_views > 1:
            probs = probs.reshape(-1, arch.num_views, arch.num_classes)
            probs = probs.mean(dim=1)
        return probs


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Fill every conv and dense kernel as the JAX package initialises it
    (glorot-uniform) and zero their biases; BN variables are created at
    their initial values (scale 1, bias 0, mean 0, var 1)."""
    for m in model.modules():
        if hasattr(m, "reset_parameters") and m is not model:
            m.reset_parameters(generator)


def create_model(cfg, dtype: Optional[torch.dtype] = None, device=None,
                 seed: int = 0, init: bool = True, remat=None,
                 bn_groups: int = 1,
                 mesh: Optional[parallel.Mesh] = None, time_fold=None,
                 fold_stages: int = 4) -> X3D:
    """Build an eval-mode :class:`X3D` from a config (``.train()`` switches
    it to training mode).

    ``bn_groups``: per-replica BN statistics over that many contiguous
    slices of this process's batch (the JAX package's ``create_model(cfg,
    bn_groups=g)``); 1 = one group.  ``mesh`` (``parallel.init_mesh``):
    the process's place in a multi-process run, on its device unless
    ``device`` is given; ``cfg.TPU.SYNC_BN`` says whether BN statistics are
    averaged over the data group, and a model axis splits the head.

    ``remat`` defaults to ``cfg.TPU.REMAT``; "auto" is per-block remat for
    the 312² variants (``DATA.TRAIN_CROP_SIZE >= 312``: X3D-L and -XL) and
    none otherwise, as ``x3d_tpu.models.create_model`` resolves it.
    ``time_fold`` defaults to ``cfg.TPU.TIME_FOLD`` (see :class:`X3D`).

    Weights are drawn on the CPU from a ``torch.Generator`` seeded with
    ``seed`` (``init=False`` leaves them to a later ``load_state_dict``),
    then moved to ``device``: CUDA unless the caller asks for another.  On
    the ``meta`` device nothing is allocated or drawn.
    """
    if device is None and mesh is not None:
        device = mesh.device
    device = utils.resolve_device(device)
    dtype = dtype or getattr(torch, cfg.TPU.COMPUTE_DTYPE)
    if remat is None:
        remat = cfg.TPU.REMAT
    if remat == "auto":
        remat = cfg.DATA.TRAIN_CROP_SIZE >= 312
    if time_fold is None:
        time_fold = cfg.TPU.TIME_FOLD
    arch = build_arch(cfg)
    build_on = device if device.type == "meta" else torch.device("cpu")
    model = X3D(arch, dtype, cfg.DATA.NUM_INPUT_CHANNELS, device=build_on,
                remat=remat, time_fold=time_fold, fold_stages=fold_stages)
    if init and build_on.type != "meta":
        init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(device).eval()
    if bn_groups != 1 or mesh is not None:
        model.set_parallel(mesh, bn_groups, bool(cfg.TPU.SYNC_BN))
    return model
