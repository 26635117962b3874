"""K7's device time per case: every bulk 1x1x1 conv of an X3D forward or
training step, through K7 as the model calls it, through each of its
tensor-core bodies on the same inputs, and through ``F.linear``.

One JSON line per case (a training step's forward and dx are two cases):
its widths and rows, the launches per forward or step, the body that ran
and its plan, device microseconds of K7 (``k7_us``), of each body that
takes the call (``wg_us``, ``pipe_us``) and of ``F.linear`` on the rows the
conv reads (``library_us``; a strided projection's subsample made
beforehand), the bound (x read once, y written once and W read once at
3.35 TB/s, or the operations at 989 TFLOP/s, whichever is larger), the
share of it K7 reaches and K7 over the library.  Device time is
``torch.profiler``'s (``tools/trace``; ``timer`` "profiler"), or, where the
profiler lost part of a case's window three times, each call's own span
between CUDA events with the stream held while the host enqueues
(``ops/timing.device_time_fn``; ``timer`` "events", which also counts the
device's gaps between kernels).  bfloat16, random inputs from a seed.
Needs a CUDA card::

    python -m x3d_tpu_torch.tools.profile_pointwise --variant M --clips 10
    python -m x3d_tpu_torch.tools.profile_pointwise --variant S --clips 64 \\
        --training
"""

from __future__ import annotations

import argparse
import json
import math

import torch
import torch.nn.functional as F

from x3d_tpu_torch import variant_config
from x3d_tpu_torch.kernels import _build
from x3d_tpu_torch.models import build_arch
from x3d_tpu_torch.ops import pointwise
from x3d_tpu_torch.ops.timing import device_time_fn
from x3d_tpu_torch.tools.trace import LostTrace, card, trace

MEM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (published)
BF16_TC_FLOP_PER_S = 989e12   # H100 SXM dense bf16 tensor cores (published)
# kernel names of K7's bodies, as the profiler reports them
BODY_KERNELS = {"wg": "pw_conv_wg_kernel", "pipe": "pw_conv_mma_kernel",
                "cuda_core": "pw_conv_kernel"}


def cases(cfg, arch, B: int, crop: int, train: bool):
    """(name, x shape, Cout, strides, launches) of every bulk 1x1x1 conv
    that runs K7 in one forward of ``B`` clips at ``crop``: all of them in a
    forward-only pass; in the training step those that K5/K6 do not take
    (the stage entries' convs a and c, the projections, conv_5)."""
    T, S = cfg.DATA.TEMP_DURATION, -(-crop // 2)
    out = []
    for si, blocks in enumerate(arch.stages):
        b0, stage = blocks[0], f"stage{si + 2}"
        out += [(f"{stage}_block0.a", (B, T, S, S, b0.in_channels),
                 b0.inner_channels, (1, 1, 1), 1),
                (f"{stage}_block0 projection", (B, T, S, S, b0.in_channels),
                 b0.out_channels, (1, 2, 2), 1)]
        S = -(-S // 2)
        out.append((f"{stage}_block0.c", (B, T, S, S, b0.inner_channels),
                    b0.out_channels, (1, 1, 1), 1))
        if not train and len(blocks) > 1:
            n = len(blocks) - 1
            out += [(f"{stage} stride-1 blocks' a",
                     (B, T, S, S, b0.out_channels), b0.inner_channels,
                     (1, 1, 1), n),
                    (f"{stage} stride-1 blocks' c",
                     (B, T, S, S, b0.inner_channels), b0.out_channels,
                     (1, 1, 1), n)]
    out.append(("conv_5", (B, T, S, S, arch.stages[-1][-1].out_channels),
                arch.conv5_dim, (1, 1, 1), 1))
    return out


def with_dx(case_list):
    """The cases of a training step: each forward and its dx (K7 on the
    cotangent and the transposed weight, stride 1 on the output grid)."""
    out = []
    for name, shape, N, strides, n in case_list:
        B, T, H, W, K = shape
        dy = (B, T, -(-H // strides[1]), -(-W // strides[2]), N)
        out += [(name, shape, N, strides, n),
                (f"{name} dx", dy, K, (1, 1, 1), n)]
    return out


def _group(name: str) -> str:
    """The K7 body a kernel belongs to, by its name; "library" otherwise."""
    for body, key in BODY_KERNELS.items():
        if key in name:
            return body
    return "library"


def case_row(shape, N: int, strides, iters: int = 10, seed: int = 0):
    """One case's device times (module docstring); bfloat16.  A profiler
    window is complete when it holds a kernel of every group it times for
    each call."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    K = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    w = (torch.randn((N, K), generator=gen, device="cuda")
         / math.sqrt(K)).bfloat16()
    xs = pointwise._subsample(x, strides).contiguous()
    M = xs.numel() // K
    nbytes = 2 * (M * K + M * N + N * K)
    t_mem, t_ops = nbytes / MEM_BYTES_PER_S, 2 * M * K * N / BF16_TC_FLOP_PER_S
    bound_us = max(t_mem, t_ops) * 1e6
    body = pointwise.pw_body(K, N, M, strides, width=shape[3],
                             height=shape[2])
    # the tensor-core bodies that take the call, on the same inputs
    bodies = [b for b in ("wg", "pipe")
              if b == body or (b == "pipe" and K % 2 == 0)]
    lib = _build.load("pointwise.cu", pointwise._SIGNATURES)
    stream = torch.cuda.current_stream().cuda_stream
    calls = {"k7": lambda: pointwise.pw_conv(x, w, strides),
             "library": lambda: F.linear(xs, w),
             **{b: lambda b=b: pointwise._launch(lib, b, x, w, strides,
                                                 stream) for b in bodies}}

    def has(*groups):
        return lambda got: all(got["group_kernels_per_call"].get(g, 0) >= 1
                               for g in groups)

    try:
        by = trace(lambda: (calls["k7"](), calls["library"]()), iters,
                   "call", group=_group,
                   complete=has(body, "library"))["group_ms_per_call"]
        times = {"k7_us": by[body] * 1e3, "library_us": by["library"] * 1e3}
        if bodies:
            got = trace(lambda: [calls[b]() for b in bodies], iters, "call",
                        group=_group,
                        complete=has(*bodies))["group_ms_per_call"]
            times.update({f"{b}_us": got[b] * 1e3 for b in bodies})
        timer = "profiler"
    except LostTrace:
        times = {f"{name}_us": device_time_fn(fn, iters=iters) * 1e6
                 for name, fn in calls.items()}
        timer = "events"
    row = {"M": M, "K": K, "N": N, "strides": list(strides), "body": body,
           "plan": pointwise.plan(shape, N, strides), **times,
           "timer": timer,
           "bound_us": bound_us,
           "bound_by": "bytes" if t_mem >= t_ops else "operations"}
    row["bound_share"] = row["bound_us"] / row["k7_us"]
    row["vs_library"] = row["k7_us"] / row["library_us"]
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", default="M")
    ap.add_argument("--clips", type=int, default=10)
    ap.add_argument("--training", action="store_true",
                    help="the training step's cases at the train crop")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_pointwise times the card; no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = variant_config(args.variant)
    arch = build_arch(cfg)
    crop = cfg.DATA.TRAIN_CROP_SIZE if args.training \
        else cfg.DATA.TEST_CROP_SIZE
    found = cases(cfg, arch, args.clips, crop, args.training)
    if args.training:
        found = with_dx(found)
    name = card()
    totals = dict.fromkeys(("k7_us", "library_us", "bound_us"), 0.0)
    for case, shape, N, strides, n in found:
        row = case_row(shape, N, strides, args.iters)
        for key in totals:
            totals[key] += n * row[key]
        print(json.dumps({"card": name, "variant": args.variant,
                          "clips": args.clips, "case": case, "n": n,
                          **row}), flush=True)
    print(json.dumps({"card": name, "variant": args.variant,
                      "clips": args.clips, "training": args.training,
                      "launches": sum(c[-1] for c in found), **totals,
                      "bound_share": totals["bound_us"] / totals["k7_us"],
                      "vs_library": totals["k7_us"] / totals["library_us"]}),
          flush=True)


if __name__ == "__main__":
    main()
