"""Hand-written CUDA kernels for Hopper and what their wrappers share.

The sources live in ``csrc/``; ``_build`` compiles them with nvcc at first
use.  The wrappers themselves live beside their plain PyTorch versions in
``x3d_tpu_torch.ops``.
"""

from __future__ import annotations

import ctypes

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor) -> int:
    """The kernels' code for ``t``'s dtype (float32 or bfloat16)."""
    try:
        return _DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(
            f"the CUDA kernels take float32 or bfloat16, got {t.dtype}") from None


def check_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous tensor on one CUDA device."""
    device = tensors[0].device
    for t in tensors:
        if t.device != device or t.device.type != "cuda":
            raise ValueError(
                f"expected tensors on one CUDA device, got {t.device} "
                f"and {device}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on_error(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


# What a library's plan function reports of a bfloat16 call of K5-K7: the
# copy granule in bytes (0: the CUDA-core route), the columns a block owns,
# the column tiles, the dynamic shared memory in bytes, the blocks an SM
# holds and the ring's stages.
PLAN_KEYS = ("granule_bytes", "block_columns", "column_tiles", "smem_bytes",
             "blocks_per_sm", "stages")


def read_plan(fn, *args: int) -> dict:
    """Call a plan function of a kernel library (``fn(*args, out)`` fills
    ``out``, an int array of len(PLAN_KEYS)) and return it by key."""
    out = (ctypes.c_int * len(PLAN_KEYS))()
    raise_on_error(fn(*args, ctypes.addressof(out)), "plan")
    return dict(zip(PLAN_KEYS, out))
