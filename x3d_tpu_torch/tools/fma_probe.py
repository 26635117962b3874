"""Probe the card's multiply-add rate per dtype (kernel K9).

The counterpart of the JAX package's ``x3d_tpu/tools/vpu_probe.py``, which
asked whether the TPU's vector unit runs packed bfloat16 arithmetic at
twice the float32 rate.  Here the same chain -- ``unroll * inner`` dependent
multiply-adds ``v = v * a + b`` per element of a block, one read and one
write of the block -- runs on the CUDA cores: ``fmaf`` for float32,
``__hfma2`` on pairs for bfloat16 (``kernels/csrc/fma_probe.cu``).

    python -m x3d_tpu_torch.tools.fma_probe [--unroll 8] [--mb 16]

Prints one JSON line with the achieved element multiply-adds per
millisecond per dtype, their share of the card's published float32 peak
(67 TFLOP/s outside the tensor cores = 33.5e12 multiply-adds/s, twice that
for packed bfloat16), and the bfloat16/float32 ratio: about 2 means packed
bfloat16 multiply-adds run at twice the float32 rate on this card.

:func:`fma_chain` is K9's wrapper and :func:`fma_chain_reference` its plain
PyTorch version (the loop on a tensor).
"""

from __future__ import annotations

import argparse
import ctypes
import json

import torch

from x3d_tpu_torch import kernels
from x3d_tpu_torch.kernels import _build
from x3d_tpu_torch.utils import resolve_device

# the TPU probe's constants: a just below 1 and b tiny, so the chain neither
# overflows nor collapses to zero
A, B = 0.999755859375, 1.52587890625e-05
F32_MADDS_PER_S = 67e12 / 2        # H100 SXM, float32 outside the tensor cores
UNROLLS = (1, 2, 4, 8, 16, 32)

_SIGNATURES = {
    "x3d_fma_chain": [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong,
                                              ctypes.c_float, ctypes.c_float,
                                              ctypes.c_int, ctypes.c_int,
                                              ctypes.c_void_p],
}


def _check(x, unroll, inner):
    if unroll not in UNROLLS:
        raise ValueError(f"unroll must be one of {UNROLLS}, got {unroll}")
    if inner < 0:
        raise ValueError(f"inner must not be negative, got {inner}")
    kernels.dtype_code(x)
    if x.dtype == torch.bfloat16 and x.numel() % 2:
        raise ValueError("a bfloat16 block holds an even number of values")


def fma_chain_reference(x: torch.Tensor, a: float = A, b: float = B,
                        unroll: int = 8, inner: int = 64) -> torch.Tensor:
    """Plain version of K9: ``unroll * inner`` times ``v = v * a + b`` on the
    tensor, each step a fused multiply-add (one rounding to x's dtype; a and
    b are rounded to x's dtype first).  The product and sum are taken in
    float64, where both are exact for these dtypes up to the final
    rounding."""
    _check(x, unroll, inner)
    a64 = torch.tensor(a, dtype=x.dtype).to(torch.float64)
    b64 = torch.tensor(b, dtype=x.dtype).to(torch.float64)
    v = x
    for _ in range(unroll * inner):
        v = (v.to(torch.float64) * a64 + b64).to(x.dtype)
    return v


def fma_chain(x: torch.Tensor, a: float = A, b: float = B, unroll: int = 8,
              inner: int = 64) -> torch.Tensor:
    """Every element of ``x`` (float32 or bfloat16) through ``unroll *
    inner`` dependent multiply-adds ``v = v * a + b`` (kernel K9).  A CPU
    tensor takes the plain version; a CUDA tensor launches K9 or raises."""
    _check(x, unroll, inner)
    if x.device.type == "cpu":
        return fma_chain_reference(x, a, b, unroll, inner)
    kernels.check_cuda(x)
    y = torch.empty_like(x)
    lib = _build.load("fma_probe.cu", _SIGNATURES)
    rc = lib.x3d_fma_chain(x.data_ptr(), y.data_ptr(), kernels.dtype_code(x),
                           x.numel(), a, b, unroll, inner,
                           kernels.stream_handle(x))
    kernels.raise_on_error(rc, "fma_chain kernel launch")
    fma_chain.launches += 1
    return y


fma_chain.launches = 0


def probe(dtype: torch.dtype, n_bytes: int, unroll: int = 8, inner: int = 64,
          iters: int = 20, device=None) -> float:
    """Achieved element multiply-adds per millisecond for one dtype, on a
    block of ``n_bytes``.  Times the card: raises without one."""
    from x3d_tpu_torch.ops.timing import time_fn

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("the probe measures the card's multiply-add rate; "
                           "the CPU has none to report")
    n = n_bytes // torch.empty((), dtype=dtype).element_size()
    x = torch.full((n,), 0.5, dtype=dtype, device=device)
    sec = time_fn(lambda: fma_chain(x, A, B, unroll, inner), iters=iters)
    return n * unroll * inner / (sec * 1e3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--unroll", type=int, default=8, choices=UNROLLS,
                    help="dependent multiply-adds per loop body")
    ap.add_argument("--mb", type=int, default=16,
                    help="block size in MiB (enough blocks to fill the card)")
    ap.add_argument("--inner", type=int, default=64,
                    help="loop trips inside the kernel")
    ap.add_argument("--iters", type=int, default=20, help="timed launches")
    args = ap.parse_args(argv)

    from x3d_tpu_torch.tools.trace import card

    n = args.mb * 1024 * 1024
    f32 = probe(torch.float32, n, args.unroll, args.inner, args.iters)
    bf16 = probe(torch.bfloat16, n, args.unroll, args.inner, args.iters)
    peak_per_ms = F32_MADDS_PER_S / 1e3
    print(json.dumps({
        "card": card(),
        "f32_madd_ops_per_ms": round(f32 / 1e6, 3),
        "bf16_madd_ops_per_ms": round(bf16 / 1e6, 3),
        "unit": "M element-madds/ms",
        "bf16_over_f32": round(bf16 / f32, 3),
        "f32_share_of_peak": round(f32 / peak_per_ms, 4),
        "bf16_share_of_packed_peak": round(bf16 / (2 * peak_per_ms), 4),
        "verdict": ("packed bf16 multiply-adds run at 2x the f32 rate"
                    if bf16 / f32 > 1.6 else
                    "packed bf16 multiply-adds run at about the f32 rate: "
                    "a bf16 kernel on the CUDA cores cannot outrun f32"),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
