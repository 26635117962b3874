"""An eval BatchNorm as the epilogue of the conv kernel that writes its input.

In eval mode a BatchNorm is the affine ``y·mul + add`` with (C,) float32
coefficients from its running statistics, computed in float32 and rounded
once to the compute dtype (``models/x3d.affine``), often followed by a
ReLU.  Every such BatchNorm of X3D's eval forward reads a tensor that K7,
K2 or K1 has just written, so the model hands the coefficients to that
launch (``mul``, ``add``, ``relu`` of :func:`pointwise.pw_conv`,
:func:`dw_fused.dw_bn_act_conv` and :func:`depthwise.depthwise_conv3d`)
and the kernel applies them as it stores its output
(``kernels/csrc/common.cuh``'s ``BnEpilogue``): the conv's output rounded
to the compute dtype as the kernel stores it without the epilogue, widened
to float32, times ``mul``, plus ``add`` as :func:`reference` computes them
on the card (a float32 output: a product and a sum, each rounded; a
bfloat16 one: ``torch.addcmul``, one fused multiply-add there), through the
ReLU where asked, rounded once.  That is the unfused conv followed by
:func:`reference`, bit for bit on the card.  K2's per-sample sums stay
the sums of the conv's output.  The bodies with the epilogue are a library
of their own (:func:`library`), so that a launch without one, training's,
runs the code it ran before there was one.

The epilogue is forward only: the model passes it in eval mode with
autograd off (serving, export), and a training step never does.  Each of
the three wrappers counts its launches with an epilogue by kind in
``epilogue_launches`` and writes the kind into an open ``ops.launch_log``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from x3d_tpu_torch.kernels import _build

# the C launch functions' last arguments: the epilogue's mul, add and relu,
# then the stream; the first three's values for a launch with no epilogue
ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
NO_POINTERS = (None, None, 0)


def kind(mul: Optional[torch.Tensor], relu: bool) -> str:
    """"none", "bn" or "bn_relu"."""
    if mul is None:
        return "none"
    return "bn_relu" if relu else "bn"


def counter() -> dict:
    """A wrapper's ``epilogue_launches``, by kind."""
    return {"bn": 0, "bn_relu": 0}


def reference(y: torch.Tensor, mul: Optional[torch.Tensor],
              add: Optional[torch.Tensor], relu: bool = False
              ) -> torch.Tensor:
    """The plain version: ``y·mul + add`` over y's last axis, in float32,
    rounded once to y's dtype (``torch.addcmul`` into y's dtype; on a
    float32 y a product and a sum), then the ReLU where asked; y itself
    where ``mul`` is None."""
    if mul is None:
        return y
    if y.dtype == torch.float32:
        out = y * mul + add
    else:
        out = torch.addcmul(add, y, mul, out=torch.empty_like(y))
    return torch.relu(out) if relu else out


def forward_only(mul: Optional[torch.Tensor], *tensors: torch.Tensor
                 ) -> None:
    """Raise where autograd would record a call with an epilogue (``mul``
    given and any of the call's tensors needing a gradient): it has no
    backward."""
    if mul is not None and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (mul, *tensors)):
        raise RuntimeError("the BN epilogue has no backward: pass it with "
                           "autograd off (eval, torch.no_grad)")


def check(mul: Optional[torch.Tensor], add: Optional[torch.Tensor],
          relu: bool, channels: int) -> None:
    """Raise unless the epilogue is none (no ``mul``, ``add`` or ``relu``)
    or two (channels,) coefficient vectors."""
    if mul is None and add is None:
        if relu:
            raise ValueError("a ReLU epilogue needs the BN coefficients")
        return
    if mul is None or add is None or tuple(mul.shape) != (channels,) \
            or tuple(add.shape) != (channels,):
        raise ValueError(
            f"the BN epilogue takes mul and add of shape ({channels},), got "
            f"{None if mul is None else tuple(mul.shape)} and "
            f"{None if add is None else tuple(add.shape)}")


def prepare(mul: Optional[torch.Tensor], add: Optional[torch.Tensor],
            x: torch.Tensor) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The coefficients as a kernel reads them: contiguous float32 on x's
    device, 16-byte aligned (vector loads; a copy where a view is not), or
    None for no epilogue."""
    if mul is None:
        return None
    out = []
    for v in (mul, add):
        v = v.to(device=x.device, dtype=torch.float32).contiguous()
        out.append(v.clone() if v.data_ptr() % 16 else v)
    return tuple(out)


def library(source: str, signatures: dict,
            coefs: Optional[Tuple[torch.Tensor, torch.Tensor]]):
    """The kernel library of ``source`` that a launch with (``coefs``) or
    without the epilogue runs: the one built with ``_build.BN_EPILOGUE``,
    or the one built without."""
    return _build.load(source, signatures,
                       () if coefs is None else _build.BN_EPILOGUE)


def pointers(coefs: Optional[Tuple[torch.Tensor, torch.Tensor]],
             relu: bool) -> tuple:
    """The C interfaces' trailing ``mul, add, relu`` arguments."""
    if coefs is None:
        return NO_POINTERS
    return coefs[0].data_ptr(), coefs[1].data_ptr(), int(relu)


def cost(kind_: str, channels: int, outputs: int,
         work: Tuple[int, int]) -> Tuple[int, int]:
    """A call's (bytes, flops): its conv's ``work`` and what its epilogue
    adds, the coefficients read (float32), a product and a sum an output,
    and the ReLU's compare where it has one."""
    if kind_ == "none":
        return work
    return (work[0] + 8 * channels,
            work[1] + (3 if kind_ == "bn_relu" else 2) * outputs)
