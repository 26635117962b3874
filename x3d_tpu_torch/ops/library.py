"""The model's forward kernels as ``torch.library`` ops.

``torch.export`` traces with fake tensors, which have no data pointers, so
it cannot trace the wrappers, which launch their kernels through ``ctypes``
on raw pointers and pick a body and a plan from the concrete shapes.  Each
op here is a thin wrapper over one launch function, with a fake version
that gives the output's shape, dtype and contiguous channels-last strides
and nothing more, so an exported program holds one node a call and runs
the launch function when it runs:

* ``x3d::depthwise_conv3d`` -- K1, :func:`depthwise.depthwise_conv3d`;
* ``x3d::dw_bn_act_conv`` -- K2, :func:`dw_fused.dw_bn_act_conv`;
* ``x3d::pw_conv`` -- K7, :func:`pointwise.pw_conv`;
* ``x3d::pw_conv_stats`` -- K5, :func:`pw_stats.pw_conv_stats`;
* ``x3d::pw_act_conv_stats`` -- K6, :func:`pw_stats.pw_act_conv_stats`.

The ops of K1, K2 and K7 end in optional ``mul``, ``add`` and ``relu``:
an eval BatchNorm applied as the kernel stores its output
(``ops/epilogue.py``), which an exported eval program passes; a call
without them is the op's call as it was before they were added.
The launch functions keep their device branch (the plain version on a CPU
tensor, the kernel or an error on a CUDA tensor) and their ``launches``,
``body_launches`` and ``epilogue_launches`` counters, so one op serves
both devices.  The model
calls the ops only where ``ops.via_library()`` holds: while it is being
exported, and inside a remat "convs" region, whose selective checkpoint
keeps these ops' outputs for the backward pass instead of running them
again (``models/x3d.py``); eager calls elsewhere go to the launch
functions directly, without the op's dispatch.  A process that loads an
exported program holding these ops imports this module first
(``x3d_tpu_torch.export.load`` does).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from x3d_tpu_torch.ops import depthwise, dw_fused, pointwise, pw_stats


def _pairs(pads: List[int]):
    return tuple((pads[i], pads[i + 1]) for i in range(0, 6, 2))


@torch.library.custom_op("x3d::depthwise_conv3d", mutates_args=())
def depthwise_conv3d(x: torch.Tensor, kernel: torch.Tensor,
                     strides: List[int], pads: List[int],
                     mul: Optional[torch.Tensor] = None,
                     add: Optional[torch.Tensor] = None,
                     relu: bool = False) -> torch.Tensor:
    """K1: (B, T, H, W, C) -> (B, To, Ho, Wo, C); ``pads`` the six ints
    (t_lo, t_hi, h_lo, h_hi, w_lo, w_hi)."""
    return depthwise.depthwise_conv3d(x, kernel, strides, _pairs(pads), mul,
                                      add, relu)


@depthwise_conv3d.register_fake
def _(x, kernel, strides, pads, mul=None, add=None, relu=False):
    B, T, H, W, C = x.shape
    out = [depthwise._out_size(n, k, s, p) for n, k, s, p in
           zip((T, H, W), kernel.shape[:3], strides, _pairs(pads))]
    return x.new_empty((B, *out, C))


@torch.library.custom_op("x3d::dw_bn_act_conv", mutates_args=())
def dw_bn_act_conv(x: torch.Tensor, a_cb: torch.Tensor, b_cb: torch.Tensor,
                   kernel: torch.Tensor, mul: Optional[torch.Tensor] = None,
                   add: Optional[torch.Tensor] = None, relu: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2: y in x's dtype, p and s2 (C, B) float32."""
    return dw_fused.dw_bn_act_conv(x, a_cb, b_cb, kernel, mul, add, relu)


@dw_bn_act_conv.register_fake
def _(x, a_cb, b_cb, kernel, mul=None, add=None, relu=False):
    B, C = x.shape[0], x.shape[-1]
    p = x.new_empty((C, B), dtype=torch.float32)
    return x.new_empty(x.shape), p, torch.empty_like(p)


@torch.library.custom_op("x3d::pw_conv", mutates_args=())
def pw_conv(x: torch.Tensor, weight: torch.Tensor, strides: List[int],
            mul: Optional[torch.Tensor] = None,
            add: Optional[torch.Tensor] = None,
            relu: bool = False) -> torch.Tensor:
    """K7: (B, T, H, W, K) x (N, K) -> (B, T, ceil(H/sh), ceil(W/sw), N)."""
    return pointwise.pw_conv(x, weight, strides, "fwd", mul, add, relu)


@pw_conv.register_fake
def _(x, weight, strides, mul=None, add=None, relu=False):
    B, T, H, W, _ = x.shape
    _, sh, sw = strides
    return x.new_empty((B, T, -(-H // sh), -(-W // sw), weight.shape[0]))


def _stats_fake(x, weight):
    """y (B, ..., Cout) in x's dtype, contiguous; p, s2 (Cout, B) float32."""
    N, B = weight.shape[0], x.shape[0]
    p = x.new_empty((N, B), dtype=torch.float32)
    return x.new_empty((*x.shape[:-1], N)), p, torch.empty_like(p)


@torch.library.custom_op("x3d::pw_conv_stats", mutates_args=())
def pw_conv_stats(x: torch.Tensor, weight: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5: y = x @ weight^T in x's dtype; p, s2 (Cout, B) float32."""
    return pw_stats.pw_conv_stats(x, weight)


@pw_conv_stats.register_fake
def _(x, weight):
    return _stats_fake(x, weight)


@torch.library.custom_op("x3d::pw_act_conv_stats", mutates_args=())
def pw_act_conv_stats(x: torch.Tensor, a_cb: torch.Tensor,
                      b_cb: torch.Tensor, weight: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6: y = swish(x * a + b) @ weight^T in x's dtype; p, s2 (Cout, B)
    float32."""
    return pw_stats.pw_act_conv_stats(x, a_cb, b_cb, weight)


@pw_act_conv_stats.register_fake
def _(x, a_cb, b_cb, weight):
    return _stats_fake(x, weight)


# the overloads a remat "convs" region keeps (models/x3d.py)
OPS = (torch.ops.x3d.depthwise_conv3d.default,
       torch.ops.x3d.dw_bn_act_conv.default,
       torch.ops.x3d.pw_conv.default,
       torch.ops.x3d.pw_conv_stats.default,
       torch.ops.x3d.pw_act_conv_stats.default)
