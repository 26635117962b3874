"""Pointwise (1x1x1) conv on NDHWC activations.

With C contiguous a 1x1x1 conv is a ``(B*T*H*W, Cin) @ (Cin, Cout)``
product.  Weights are ``(Cout, Cin)``.

* :func:`pointwise_conv3d` is the differentiable op the model calls.  A
  bulk conv -- a 5-D input with more than one position and no bias
  (:func:`routes_to_kernel`) -- goes to the hand-written CUDA kernel K7
  (``kernels/csrc/pointwise.cu``: bfloat16 on the pipelined tensor-core
  body of ``pw_gemm.cuh``, float32 on the CUDA cores without TF32), which
  replaces the TPU kernel ``pw_batchminor._pw_kernel``; its backward's dx
  is K7 again on the cotangent and the transposed weight, its dk the
  float32 contraction ``x^T g`` left to ``torch.matmul`` (as the JAX
  package leaves it to XLA).
  The Squeeze-Excite and head layers (one position, or a bias) stay
  ``F.linear``, as the JAX package leaves them to XLA.
* :func:`pw_conv` is K7's wrapper; :func:`pointwise_conv3d_reference` is
  the plain PyTorch version (``F.linear``).

A strided projection reads every s-th row and column (a 1x1x1 kernel with
stride s is a subsample); K7 reads them in place.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from x3d_tpu_torch import kernels, ops
from x3d_tpu_torch.kernels import _build

_SIGNATURES = {
    "x3d_pw_conv": [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong]
    + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "x3d_pw_conv_plan": [ctypes.c_int] * 2 + [ctypes.c_void_p],
}


def _subsample(x: torch.Tensor, strides: Sequence[int]) -> torch.Tensor:
    if tuple(strides) == (1, 1, 1):
        return x
    st, sh, sw = strides
    if st != 1 or x.dim() != 5:
        raise ValueError(f"a strided 1x1x1 conv takes a 5-D input and "
                         f"strides (1, sh, sw), got {tuple(strides)}")
    return x[:, :, ::sh, ::sw, :]


def pointwise_conv3d_reference(x: torch.Tensor, weight: torch.Tensor,
                               strides: Sequence[int] = (1, 1, 1),
                               bias: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Plain version: subsample, then ``F.linear`` in x's dtype."""
    return F.linear(_subsample(x, strides), weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype))


def routes_to_kernel(x_shape: Sequence[int], has_bias: bool,
                     strides: Sequence[int] = (1, 1, 1)) -> bool:
    """Whether a 1x1x1 conv on an input of this shape is a bulk conv (K7 on
    a CUDA tensor): 5-D, more than one output position, no bias."""
    if len(x_shape) != 5 or has_bias:
        return False
    _, sh, sw = strides
    positions = x_shape[1] * -(-x_shape[2] // sh) * -(-x_shape[3] // sw)
    return positions > 1


def pw_conv(x: torch.Tensor, weight: torch.Tensor,
            strides: Sequence[int] = (1, 1, 1)) -> torch.Tensor:
    """y = x[:, :, ::sh, ::sw] @ weight^T (kernel K7).

    Args:
      x: (B, T, H, W, Cin) float32 or bfloat16.
      weight: (Cout, Cin), rounded to x's dtype.
      strides: (1, sh, sw).

    Returns:
      y (B, T, ceil(H/sh), ceil(W/sw), Cout) in x's dtype, summed in
      float32 and rounded once.

    A CPU tensor takes the plain version; a CUDA tensor launches K7 or
    raises.
    """
    if x.dim() != 5 or weight.dim() != 2 or weight.shape[1] != x.shape[-1]:
        raise ValueError(f"expected x (B, T, H, W, Cin) and weight (Cout, "
                         f"Cin), got {tuple(x.shape)} and "
                         f"{tuple(weight.shape)}")
    st, sh, sw = (int(s) for s in strides)
    if st != 1 or sh < 1 or sw < 1:
        raise ValueError(f"strides must be (1, sh, sw), got {tuple(strides)}")
    if x.device.type == "cpu":
        return pointwise_conv3d_reference(x, weight, (st, sh, sw))
    kernels.check_cuda(x)
    B, T, H, W, K = x.shape
    N = weight.shape[0]
    w = weight.to(x.dtype).contiguous()
    y = torch.empty((B, T, -(-H // sh), -(-W // sw), N), dtype=x.dtype,
                    device=x.device)
    kernels.check_cuda(x, w, y)
    lib = _build.load("pointwise.cu", _SIGNATURES)
    rc = lib.x3d_pw_conv(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                         kernels.dtype_code(x), B * T, H, W, K, N, sh, sw,
                         kernels.stream_handle(x))
    kernels.raise_on_error(rc, "pw_conv kernel launch")
    pw_conv.launches += 1
    return y


pw_conv.launches = 0


def plan(cin: int, cout: int) -> dict:
    """How a bfloat16 call of K7 at these widths runs on the card, with
    aligned tensors (keys ``kernels.PLAN_KEYS``).  Builds the kernel; needs
    a CUDA card."""
    lib = _build.load("pointwise.cu", _SIGNATURES)
    return kernels.read_plan(lib.x3d_pw_conv_plan, cin, cout)


class _Pointwise(torch.autograd.Function):
    """K7 forward; backward: dx = K7 on the cotangent and the transposed
    weight (scattered back onto the strided positions), dW = g^T x in
    float32."""

    @staticmethod
    def forward(ctx, x, weight, strides):
        ctx.save_for_backward(x, weight)
        ctx.strides = strides
        return pw_conv(x, weight, strides)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        strides = ctx.strides
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dxs = pw_conv(g, weight.to(x.dtype).t())
            if strides == (1, 1, 1):
                dx = dxs
            else:
                dx = torch.zeros_like(x)
                dx[:, :, ::strides[1], ::strides[2], :] = dxs
        if ctx.needs_input_grad[1]:
            xs = _subsample(x, strides)
            K, N = weight.shape[1], weight.shape[0]
            dw = torch.matmul(g.reshape(-1, N).to(torch.float32).t(),
                              xs.reshape(-1, K).to(torch.float32))
            dw = dw.to(weight.dtype)
        return dx, dw, None


def pointwise_conv3d(x: torch.Tensor, weight: torch.Tensor,
                     strides: Sequence[int] = (1, 1, 1),
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (..., Cin) in the compute dtype; weight: (Cout, Cin).

    A bulk conv (:func:`routes_to_kernel`) runs K7 and its backward -- on a
    CPU tensor their plain versions -- unless ``ops.plain_versions()`` is
    on; everything else is ``F.linear``."""
    strides = tuple(int(s) for s in strides)
    if ops.plain_versions_enabled() \
            or not routes_to_kernel(x.shape, bias is not None, strides):
        return pointwise_conv3d_reference(x, weight, strides, bias)
    return _Pointwise.apply(x.contiguous(), weight, strides)
