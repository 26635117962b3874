"""The bottleneck's 1x1x1 convs with BN sums: GEMMs with a sum epilogue.

    K5  pw_conv_stats:      y = x @ W^T
    K6  pw_act_conv_stats:  y = swish(x * a + b) @ W^T
    both:                   p = sum_thw y32,  s2 = sum_thw y32^2

on NDHWC activations x (B, T, H, W, Cin) with weights W (Cout, Cin); y32 is
the float32 product before it is rounded to x's dtype, so the sums do not
see that rounding.  ``p``/``s2`` are (Cout, B) float32 columns, one per
sample: the next BN's batch statistics come from them (and per-replica BN
will).  K6's (Cin, B) float32 columns ``a, b`` carry the previous BN's
affine times the Squeeze-Excite gate; u = swish(x*a + b) is rounded to x's
dtype before the product.

:func:`pw_conv_stats` and :func:`pw_act_conv_stats` are the wrappers of the
hand-written CUDA kernels K5 and K6 (``kernels/csrc/pw_stats.cu``; bfloat16
on the pipelined tensor-core body of ``pw_gemm.cuh``), which
replace the TPU kernels ``pw_batchminor._pw_stats_kernel`` and
``_pw_act_stats_kernel``; the ``*_reference`` functions are their plain
PyTorch versions.  :func:`conv_stats` and :func:`act_conv_stats` are the
differentiable ops the model calls.  Their backward is plain PyTorch and
``torch.matmul``, as the JAX package's is plain XLA
(``pw_batchminor._pw_stats_bwd``, ``_pw_act_stats_bwd``).
:func:`conv_stats_cost` and :func:`act_conv_stats_cost` give a call's least
bytes and operations, which the wrappers write into an open
``ops.launch_log`` with the body :func:`body` names.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from x3d_tpu_torch import kernels, ops
from x3d_tpu_torch.kernels import _build
from x3d_tpu_torch.ops import ring
from x3d_tpu_torch.ops.pointwise import PIPE_MAX_K

_SIGNATURES = {
    "x3d_pw_stats_tiles": [ctypes.c_int],
    "x3d_pw_conv_stats": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    "x3d_pw_act_conv_stats": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    "x3d_pw_stats_plan": [ctypes.c_int] * 3 + [ctypes.c_void_p],
}


def _dims(x, weight, a_cb=None, b_cb=None):
    if x.dim() < 2 or weight.dim() != 2 or weight.shape[1] != x.shape[-1]:
        raise ValueError(f"expected x (B, ..., Cin) and weight (Cout, Cin), "
                         f"got {tuple(x.shape)} and {tuple(weight.shape)}")
    B, K, N = x.shape[0], x.shape[-1], weight.shape[0]
    S = x.numel() // max(B * K, 1)
    for cb in (a_cb, b_cb):
        if cb is not None and tuple(cb.shape) != (K, B):
            raise ValueError(f"coefficient columns must be (Cin, B) = "
                             f"{(K, B)}, got {tuple(cb.shape)}")
    return B, S, K, N


def _cols(cb, B):
    """(C, B) columns -> (B, 1, C) float32, broadcastable over (B, S, C)."""
    return cb.t().reshape(B, 1, -1).to(torch.float32)


def _sums(y32, B):
    """(B, S, N) float32 -> p, s2 as (N, B) columns."""
    return (y32.sum(dim=1).t().contiguous(),
            (y32 * y32).sum(dim=1).t().contiguous())


def _swish_input(x, a_cb, b_cb, B, S, K):
    """v = x*a + b in float32 and u = swish(v) rounded to x's dtype, as
    (B, S, K); also sigmoid(v) for the backward."""
    v = x.reshape(B, S, K).to(torch.float32) * _cols(a_cb, B) + _cols(b_cb, B)
    sig = torch.sigmoid(v)
    return v, sig, (v * sig).to(x.dtype)


def pw_conv_stats_reference(x, weight):
    """Plain version of K5 with the kernel's semantics."""
    B, S, K, N = _dims(x, weight)
    w = weight.to(x.dtype).to(torch.float32)
    y32 = torch.matmul(x.reshape(B, S, K).to(torch.float32), w.t())
    p, s2 = _sums(y32, B)
    return y32.to(x.dtype).reshape(*x.shape[:-1], N), p, s2


def pw_act_conv_stats_reference(x, a_cb, b_cb, weight):
    """Plain version of K6 with the kernel's semantics."""
    B, S, K, N = _dims(x, weight, a_cb, b_cb)
    _, _, u = _swish_input(x, a_cb, b_cb, B, S, K)
    w = weight.to(x.dtype).to(torch.float32)
    y32 = torch.matmul(u.to(torch.float32), w.t())
    p, s2 = _sums(y32, B)
    return y32.to(x.dtype).reshape(*x.shape[:-1], N), p, s2


def conv_stats_cost(M: int, K: int, N: int, B: int,
                    elem: int) -> Tuple[int, int]:
    """A K5 call's (bytes, flops): x (M rows of K) and the weight read, y
    written, the (N, B) float32 sums p and s2 written; 2 M K N."""
    return (M * (K + N) + N * K) * elem + 2 * N * B * 4, 2 * M * K * N


def act_conv_stats_cost(M: int, K: int, N: int, B: int,
                        elem: int) -> Tuple[int, int]:
    """A K6 call's (bytes, flops): K5's and the (K, B) float32 columns a, b
    read; the products' 2 M K N (the swish prologue's M K are left out)."""
    nbytes, flops = conv_stats_cost(M, K, N, B, elem)
    return nbytes + 2 * K * B * 4, flops


def body(K: int, elem: int, aligned: int) -> str:
    """Which body runs a K5 or K6 call: "pipe" (``pw_gemm.cuh``'s
    tensor-core body: bfloat16, a copy granule of at least 4 bytes -- an
    even K, 4-byte aligned x and W -- and K up to the pipe plan's
    PIPE_MAX_K), else "cuda_core" (``pw_stats_kernel``)."""
    if elem == 2 and K % 2 == 0 and K <= PIPE_MAX_K and aligned % 4 == 0:
        return "pipe"
    return "cuda_core"


def _log(kernel, x, w, dims, cost_fn) -> None:
    """Log a call on x with the weight ``w`` the kernel read (None: the
    plain version ran)."""
    B, S, K, N = dims
    elem = x.element_size()
    ops.log_launch(kernel, "plain" if w is None
                   else body(K, elem, ring.align(x, w)),
                   {"M": B * S, "K": K, "N": N}, "fwd", x.dtype,
                   cost_fn(B * S, K, N, B, elem))


def _launch(fn_name, what, x, weight, cols, dims):
    B, S, K, N = dims
    kernels.check_cuda(x)
    w = weight.to(x.dtype).contiguous()
    cols = [c.to(torch.float32).contiguous() for c in cols]
    lib = _build.load("pw_stats.cu", _SIGNATURES)
    tiles = lib.x3d_pw_stats_tiles(S)
    y = torch.empty((*x.shape[:-1], N), dtype=x.dtype, device=x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    part_p = torch.empty((B, tiles, N), **f32)
    part_s2 = torch.empty_like(part_p)
    p = torch.empty((N, B), **f32)
    s2 = torch.empty_like(p)
    kernels.check_cuda(x, w, *cols, y, part_p, part_s2, p, s2)
    rc = getattr(lib, fn_name)(
        x.data_ptr(), *(c.data_ptr() for c in cols), w.data_ptr(),
        y.data_ptr(), part_p.data_ptr(), part_s2.data_ptr(), p.data_ptr(),
        s2.data_ptr(), kernels.dtype_code(x), B, S, K, N,
        kernels.stream_handle(x))
    kernels.raise_on_error(rc, f"{what} kernel launch")
    return (y, p, s2), w


def pw_conv_stats(x, weight):
    """y = x @ weight^T with per-sample float32 sums of y and y^2 (K5).

    Args:
      x: (B, T, H, W, Cin) float32 or bfloat16.
      weight: (Cout, Cin), rounded to x's dtype.

    Returns:
      y (B, T, H, W, Cout) in x's dtype; p, s2 (Cout, B) float32, taken
      from the float32 product before rounding.

    A CPU tensor takes the plain version; a CUDA tensor launches K5 or
    raises.
    """
    dims = _dims(x, weight)
    if x.device.type == "cpu":
        out, w = pw_conv_stats_reference(x, weight), None
    else:
        out, w = _launch("x3d_pw_conv_stats", "pw_conv_stats", x, weight,
                         [], dims)
        pw_conv_stats.launches += 1
    if ops.records is not None:
        _log("K5", x, w, dims, conv_stats_cost)
    return out


def pw_act_conv_stats(x, a_cb, b_cb, weight):
    """y = swish(x*a + b) @ weight^T with per-sample float32 sums (K6).

    Args:
      x: (B, T, H, W, Cin) float32 or bfloat16.
      a_cb, b_cb: (Cin, B) float32 coefficient columns.
      weight: (Cout, Cin), rounded to x's dtype.

    Returns:
      as :func:`pw_conv_stats`.  A CPU tensor takes the plain version; a
      CUDA tensor launches K6 or raises.
    """
    dims = _dims(x, weight, a_cb, b_cb)
    if x.device.type == "cpu":
        out, w = pw_act_conv_stats_reference(x, a_cb, b_cb, weight), None
    else:
        out, w = _launch("x3d_pw_act_conv_stats", "pw_act_conv_stats", x,
                         weight, [a_cb, b_cb], dims)
        pw_act_conv_stats.launches += 1
    if ops.records is not None:
        _log("K6", x, w, dims, act_conv_stats_cost)
    return out


pw_conv_stats.launches = 0
pw_act_conv_stats.launches = 0


def plan(cin: int, cout: int, act: bool) -> dict:
    """How a bfloat16 call of K5 (``act`` False) or K6 at these widths runs
    on the card, with aligned tensors (keys ``kernels.PLAN_KEYS``).  Builds
    the kernel; needs a CUDA card."""
    lib = _build.load("pw_stats.cu", _SIGNATURES)
    return kernels.read_plan(lib.x3d_pw_stats_plan, cin, cout, int(act))


def _dy(gy, gp, gs2, y, B, S, N):
    """dL/dy = (gy + gp) + 2 y gs2 in float32, rounded to y's dtype, as
    (B, S, N); absent cotangents count as zeros."""
    y32 = y.reshape(B, S, N).to(torch.float32)
    dy = torch.zeros_like(y32) if gy is None \
        else gy.reshape(B, S, N).to(torch.float32)
    if gp is not None:
        dy = dy + _cols(gp, B)
    if gs2 is not None:
        dy = dy + 2.0 * y32 * _cols(gs2, B)
    return dy.to(y.dtype)


def _weight_grad(dy, u, N, K):
    """dW = dy^T u over every row, in float32: (N, K)."""
    return torch.matmul(dy.reshape(-1, N).to(torch.float32).t(),
                        u.reshape(-1, K).to(torch.float32))


def _forward(reference, launch, op_name):
    """The forward a Function calls: the plain version within
    ``ops.plain_versions()``, the ``x3d::`` op where ``ops.via_library()``
    holds, else the launch function."""
    if ops.plain_versions_enabled():
        return reference
    if ops.via_library():
        from x3d_tpu_torch.ops import library
        return getattr(library, op_name)
    return launch


class _ConvStats(torch.autograd.Function):
    """K5 forward (``x3d::pw_conv_stats`` where ``ops.via_library()``);
    plain backward: dx = dy @ W in x's dtype, dW = dy^T x in float32."""

    @staticmethod
    def forward(ctx, x, weight):
        ctx.set_materialize_grads(False)
        fwd = _forward(pw_conv_stats_reference, pw_conv_stats,
                       "pw_conv_stats")
        y, p, s2 = fwd(x, weight)
        ctx.save_for_backward(x, weight, y)
        return y, p, s2

    @staticmethod
    def backward(ctx, gy, gp, gs2):
        x, weight, y = ctx.saved_tensors
        B, S, K, N = _dims(x, weight)
        dy = _dy(gy, gp, gs2, y, B, S, N)
        dx = torch.matmul(dy, weight.to(x.dtype)).reshape(x.shape)
        dw = _weight_grad(dy, x, N, K).to(weight.dtype)
        return dx, dw


class _ActConvStats(torch.autograd.Function):
    """K6 forward (``x3d::pw_act_conv_stats`` where ``ops.via_library()``);
    plain backward that recomputes u from (x, a, b)."""

    @staticmethod
    def forward(ctx, x, a_cb, b_cb, weight):
        ctx.set_materialize_grads(False)
        fwd = _forward(pw_act_conv_stats_reference, pw_act_conv_stats,
                       "pw_act_conv_stats")
        y, p, s2 = fwd(x, a_cb, b_cb, weight)
        ctx.save_for_backward(x, a_cb, b_cb, weight, y)
        return y, p, s2

    @staticmethod
    def backward(ctx, gy, gp, gs2):
        x, a_cb, b_cb, weight, y = ctx.saved_tensors
        B, S, K, N = _dims(x, weight)
        v, sig, u = _swish_input(x, a_cb, b_cb, B, S, K)
        dy = _dy(gy, gp, gs2, y, B, S, N)
        du = torch.matmul(dy, weight.to(x.dtype)).to(torch.float32)
        dv = du * (sig * (1.0 + v * (1.0 - sig)))            # swish'
        dx = (dv * _cols(a_cb, B)).to(x.dtype).reshape(x.shape)
        da = (dv * x.reshape(B, S, K).to(torch.float32)).sum(dim=1).t()
        db = dv.sum(dim=1).t()
        dw = _weight_grad(dy, u, N, K).to(weight.dtype)
        return dx, da.contiguous(), db.contiguous(), dw


def conv_stats(x, weight):
    """Differentiable K5: (y, p, s2) as :func:`pw_conv_stats`."""
    return _ConvStats.apply(x.contiguous(), weight)


def act_conv_stats(x, a_cb, b_cb, weight):
    """Differentiable K6: (y, p, s2) as :func:`pw_act_conv_stats`."""
    return _ActConvStats.apply(x.contiguous(), a_cb.contiguous(),
                               b_cb.contiguous(), weight)
