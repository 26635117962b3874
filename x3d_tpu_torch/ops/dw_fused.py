"""Fused bottleneck segment: BN affine + ReLU -> depthwise conv -> BN sums.

    y = dwconv3d(relu(a*x + b), k),  p = sum_thw(y),  s2 = sum_thw(y^2)

:func:`dw_bn_act_conv` is the wrapper of the hand-written CUDA kernel K2
(``kernels/csrc/dw_fused.cu``), which replaces the TPU kernel
``dw_fused._fwd_kernel`` of the JAX package; :func:`reference` is its plain
PyTorch version.  :func:`dw_bn_act_conv_bwd` is the wrapper of K3
(``kernels/csrc/dw_fused_bwd.cu``), the one-pass backward, which replaces
``dw_fused._bwd_kernel``; :func:`bwd_reference` is its plain version.
:func:`segment` is the differentiable op the model calls (K2 forward, K3
backward, or the plain versions within ``ops.plain_versions()``).

* ``a, b`` are (C, B) float32 normalise coefficients, one column per
  sample, computed outside from running (or, in training, batch)
  statistics.  Serving passes constant columns; per-sample columns are what
  per-replica BN will need.
* ``p``/``s2`` are per-(channel, sample) float32 sums over (T, H, W) of y
  as stored in x's dtype.  In serving, ``p`` gives the Squeeze-Excite pool.
* Stride 1, SAME padding, odd kernel dims, T >= kt.  Out-of-image elements
  of u = relu(a*x + b) are zero.
"""

from __future__ import annotations

import ctypes

import torch

from x3d_tpu_torch import kernels, ops
from x3d_tpu_torch.kernels import _build
from x3d_tpu_torch.ops.depthwise import (depthwise_conv3d_dk_reference,
                                         depthwise_conv3d_reference,
                                         same_pads)

_SIGNATURES = {
    "x3d_dw_bn_act_conv_tiles": [ctypes.c_int] * 3,
    "x3d_dw_bn_act_conv_fwd": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
    + [ctypes.c_void_p],
}
_BWD_SIGNATURES = {
    "x3d_dw_bn_act_conv_bwd_tiles": [ctypes.c_int] * 2,
    "x3d_dw_bn_act_conv_bwd": [ctypes.c_void_p] * 15 + [ctypes.c_int] * 9
    + [ctypes.c_void_p],
}


def _dims(x, kernel):
    B, T, H, W, C = x.shape
    kt, kh, kw = kernel.shape[:3]
    if kt % 2 == 0 or kh % 2 == 0 or kw % 2 == 0:
        raise ValueError("dw_fused supports odd kernel dims only")
    if T < kt:
        raise ValueError(f"dw_fused requires T >= kt (got T={T}, kt={kt})")
    return B, T, H, W, C, kt, kh, kw


def _check(x, a_cb, b_cb, kernel):
    if x.dim() != 5 or kernel.dim() != 5 or kernel.shape[3] != 1 \
            or kernel.shape[4] != x.shape[4]:
        raise ValueError(
            f"expected x (B,T,H,W,C) and taps (kt,kh,kw,1,C), got "
            f"{tuple(x.shape)} and {tuple(kernel.shape)}")
    dims = _dims(x, kernel)
    want = (x.shape[4], x.shape[0])
    if tuple(a_cb.shape) != want or tuple(b_cb.shape) != want:
        raise ValueError(f"coefficient columns must be (C, B) = {want}, got "
                         f"{tuple(a_cb.shape)} and {tuple(b_cb.shape)}")
    return dims


def reference(x, a_cb, b_cb, kernel):
    """Plain version with the kernel's semantics."""
    B, T, H, W, C, kt, kh, kw = _check(x, a_cb, b_cb, kernel)
    u = _relu_affine(x, a_cb, b_cb, B, C)
    y = depthwise_conv3d_reference(u, kernel.to(u.dtype), (1, 1, 1),
                                   _same(T, H, W, kt, kh, kw))
    y32 = y.to(torch.float32)
    p = y32.sum(dim=(1, 2, 3)).t().contiguous()
    s2 = (y32 * y32).sum(dim=(1, 2, 3)).t().contiguous()
    return y, p, s2


def dw_bn_act_conv(x, a_cb, b_cb, kernel):
    """y = dwconv(relu(a*x + b), kernel); p = sum_thw y; s2 = sum_thw y^2.

    Args:
      x: (B, T, H, W, C) raw (pre-BN) input, float32 or bfloat16.
      a_cb, b_cb: (C, B) float32 normalise coefficients.
      kernel: (kt, kh, kw, 1, C) depthwise taps (odd dims, stride 1, SAME),
        rounded to x's dtype; the kernel sums taps in float32.

    Returns:
      y: (B, T, H, W, C) in x.dtype;  p, s2: (C, B) float32.

    A CPU tensor takes the plain version; a CUDA tensor launches K2 or
    raises.
    """
    B, T, H, W, C, kt, kh, kw = _check(x, a_cb, b_cb, kernel)
    if x.device.type == "cpu":
        return reference(x, a_cb, b_cb, kernel)
    kernels.check_cuda(x)
    a = a_cb.to(torch.float32).contiguous()
    b = b_cb.to(torch.float32).contiguous()
    taps = kernel.to(x.dtype).to(torch.float32).reshape(kt * kh * kw, C)
    taps = taps.contiguous()
    code = kernels.dtype_code(x)
    lib = _build.load("dw_fused.cu", _SIGNATURES)
    tiles = lib.x3d_dw_bn_act_conv_tiles(T, H, W)
    y = torch.empty_like(x)
    part = torch.empty((2, B, tiles, C), dtype=torch.float32, device=x.device)
    p = torch.empty((C, B), dtype=torch.float32, device=x.device)
    s2 = torch.empty_like(p)
    kernels.check_cuda(x, a, b, taps, y, part, p, s2)
    rc = lib.x3d_dw_bn_act_conv_fwd(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), taps.data_ptr(),
        y.data_ptr(), part[0].data_ptr(), part[1].data_ptr(), p.data_ptr(),
        s2.data_ptr(), code, B, T, H, W, C, kt, kh, kw,
        kernels.stream_handle(x))
    kernels.raise_on_error(rc, "dw_bn_act_conv kernel launch")
    dw_bn_act_conv.launches += 1
    return y, p, s2


dw_bn_act_conv.launches = 0


# ---------------------------------------------------------- K3: backward


def _columns(cb, B, C):
    """(C, B) float32 columns -> (B, 1, 1, 1, C), broadcastable over x."""
    return cb.t().reshape(B, 1, 1, 1, C).to(torch.float32)


def _relu_affine(x, a_cb, b_cb, B, C):
    """u = relu(a*x + b) in float32, rounded to x's dtype."""
    u = x.to(torch.float32) * _columns(a_cb, B, C) + _columns(b_cb, B, C)
    return torch.relu(u).to(x.dtype)


def _same(T, H, W, kt, kh, kw):
    return tuple(same_pads(n, k, 1) for n, k in zip((T, H, W), (kt, kh, kw)))


def _g_eff(gy, gp, gs2, y, B, C):
    """g = (gy + gp) + 2 gs2 * y in float32, rounded to y's dtype: the
    cotangent of y once the sums' cotangents are folded in."""
    g = gy.to(torch.float32) + _columns(gp, B, C)
    return (g + _columns(2.0 * gs2, B, C) * y.to(torch.float32)).to(y.dtype)


def bwd_reference(x, a_cb, b_cb, kernel, y, gy, gp, gs2):
    """Plain version of K3: (dx, dk, dzs, duu) with the kernel's semantics.

    dx (B, T, H, W, C) in x's dtype; dk (kt, kh, kw, 1, C) float32; dzs =
    sum_thw dz and duu = sum_thw dz * u, (C, B) float32, where u =
    relu(a*x + b) and dz = conv(g, flip(k)) where u > 0.
    """
    B, T, H, W, C, kt, kh, kw = _check(x, a_cb, b_cb, kernel)
    a = _columns(a_cb, B, C)
    u = _relu_affine(x, a_cb, b_cb, B, C)
    g = _g_eff(gy, gp, gs2, y, B, C)
    pads = _same(T, H, W, kt, kh, kw)
    flipped = kernel.to(x.dtype).to(torch.float32).flip(0, 1, 2)
    du = depthwise_conv3d_reference(g.to(torch.float32), flipped, (1, 1, 1),
                                    pads)
    u32 = u.to(torch.float32)
    dz = torch.where(u32 > 0, du, torch.zeros_like(du))
    dx = (dz * a).to(x.dtype)
    dk = depthwise_conv3d_dk_reference(u, g, (kt, kh, kw), (1, 1, 1), pads)
    dzs = dz.sum(dim=(1, 2, 3)).t().contiguous()
    duu = (dz * u32).sum(dim=(1, 2, 3)).t().contiguous()
    return dx, dk, dzs, duu


def bwd_abs_sums(x, a_cb, b_cb, kernel, y, gy, gp, gs2):
    """The sums of :func:`bwd_reference` (dk, dzs, duu) taken over absolute
    values -- |u| |g| per tap, and |du| = conv(|g|, |k|) with |du| |u| --
    the scale against which the rounding of those sums is judged."""
    B, T, H, W, C, kt, kh, kw = _check(x, a_cb, b_cb, kernel)
    u = _relu_affine(x, a_cb, b_cb, B, C).to(torch.float32)
    g = _g_eff(gy, gp, gs2, y, B, C).to(torch.float32).abs()
    pads = _same(T, H, W, kt, kh, kw)
    du = depthwise_conv3d_reference(
        g, kernel.to(torch.float32).abs().flip(0, 1, 2), (1, 1, 1), pads)
    dk = depthwise_conv3d_dk_reference(u, g, (kt, kh, kw), (1, 1, 1), pads)
    return (dk, du.sum(dim=(1, 2, 3)).t(), (du * u).sum(dim=(1, 2, 3)).t())


def dw_bn_act_conv_bwd(x, a_cb, b_cb, kernel, y, gy, gp, gs2):
    """The backward of :func:`dw_bn_act_conv` in one pass (kernel K3).

    Args:
      x, a_cb, b_cb, kernel: the forward's inputs; y its output.
      gy: (B, T, H, W, C) cotangent of y, in x's dtype.
      gp, gs2: (C, B) float32 cotangents of p and s2.

    Returns:
      dx (B, T, H, W, C) in x's dtype; dk (kt, kh, kw, 1, C) float32; dzs,
      duu (C, B) float32 (see :func:`bwd_reference`).

    A CPU tensor takes the plain version; a CUDA tensor launches K3 or
    raises.
    """
    B, T, H, W, C, kt, kh, kw = _check(x, a_cb, b_cb, kernel)
    if tuple(y.shape) != tuple(x.shape) or tuple(gy.shape) != tuple(x.shape):
        raise ValueError("y and its cotangent must have x's shape")
    if x.device.type == "cpu":
        return bwd_reference(x, a_cb, b_cb, kernel, y, gy, gp, gs2)
    kernels.check_cuda(x)
    cols = [t.to(torch.float32).contiguous() for t in (a_cb, b_cb, gp, gs2)]
    taps = kernel.to(x.dtype).to(torch.float32).reshape(kt * kh * kw, C)
    taps = taps.contiguous()
    y, gy = y.to(x.dtype).contiguous(), gy.to(x.dtype).contiguous()
    lib = _build.load("dw_fused_bwd.cu", _BWD_SIGNATURES)
    tiles = lib.x3d_dw_bn_act_conv_bwd_tiles(H, W)
    dx = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    part_dk = torch.empty((B, tiles, kt * kh * kw, C), **f32)
    part_dzs = torch.empty((B, tiles, C), **f32)
    part_duu = torch.empty_like(part_dzs)
    dk = torch.empty((kt * kh * kw, C), **f32)
    dzs = torch.empty((C, B), **f32)
    duu = torch.empty_like(dzs)
    kernels.check_cuda(x, y, gy, *cols, taps, dx, part_dk, part_dzs,
                       part_duu, dk, dzs, duu)
    rc = lib.x3d_dw_bn_act_conv_bwd(
        x.data_ptr(), y.data_ptr(), gy.data_ptr(),
        *(t.data_ptr() for t in cols), taps.data_ptr(), dx.data_ptr(),
        part_dk.data_ptr(), part_dzs.data_ptr(), part_duu.data_ptr(),
        dk.data_ptr(), dzs.data_ptr(), duu.data_ptr(), kernels.dtype_code(x),
        B, T, H, W, C, kt, kh, kw, kernels.stream_handle(x))
    kernels.raise_on_error(rc, "dw_bn_act_conv_bwd kernel launch")
    dw_bn_act_conv_bwd.launches += 1
    return dx, dk.reshape(kt, kh, kw, 1, C), dzs, duu


dw_bn_act_conv_bwd.launches = 0


class _Segment(torch.autograd.Function):
    """K2 forward, K3 backward; within ``ops.plain_versions()`` both run
    their plain versions.  Unused outputs' cotangents arrive as None (in
    training s2 feeds BN only and the SE pool reads p alone) and count as
    zeros."""

    @staticmethod
    def forward(ctx, x, a_cb, b_cb, kernel):
        ctx.set_materialize_grads(False)
        fwd = reference if ops.plain_versions_enabled() else dw_bn_act_conv
        y, p, s2 = fwd(x, a_cb, b_cb, kernel)
        ctx.save_for_backward(x, a_cb, b_cb, kernel, y)
        return y, p, s2

    @staticmethod
    def backward(ctx, gy, gp, gs2):
        x, a_cb, b_cb, kernel, y = ctx.saved_tensors
        gy = torch.zeros_like(y) if gy is None else gy
        gp = torch.zeros_like(a_cb) if gp is None else gp
        gs2 = torch.zeros_like(a_cb) if gs2 is None else gs2
        bwd = bwd_reference if ops.plain_versions_enabled() \
            else dw_bn_act_conv_bwd
        dx, dk, dzs, duu = bwd(x, a_cb, b_cb, kernel, y, gy, gp, gs2)
        # da = sum dz * x, with x = (u - b) / a where dz != 0; undefined
        # (and set to 0) where a == 0, as the JAX rule does
        zero = torch.zeros_like(duu)
        safe = torch.where(a_cb != 0, a_cb, torch.ones_like(a_cb))
        da = torch.where(a_cb != 0, (duu - b_cb * dzs) / safe, zero)
        return dx, da, dzs, dk.to(kernel.dtype)


def segment(x, a_cb, b_cb, kernel):
    """The differentiable fused segment: (y, p, s2) as
    :func:`dw_bn_act_conv`, with gradients for x, both coefficient columns
    and the taps (float32 parameters)."""
    return _Segment.apply(x.contiguous(), a_cb.contiguous(),
                          b_cb.contiguous(), kernel)
