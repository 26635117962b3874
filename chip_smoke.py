#!/usr/bin/env python3
"""Drive the PyTorch port's X3D-M serving and training paths on one CUDA card.

Run from the repository root, on a machine with one NVIDIA H100 and the
CUDA toolkit::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``x3d_tpu_torch/kernels/csrc`` (one
nvcc per source, in parallel) and then:

* holds the serving kernels K1 (depthwise conv) and K2 (fused BN+ReLU ->
  depthwise -> sums) against their plain PyTorch versions at every X3D-M
  serving shape (B = 10 clips, float32 and bfloat16) and times kernel,
  plain version and the library's ``F.conv3d(groups=C)``;
* serves X3D-M at full width (16×224², 10 views, bfloat16, random weights
  from a seed) through ``InferenceEngine``, checks the probabilities and
  that each forward launched K1 5 times and K2 22 times, and checks one
  float32 forward through the kernels against the same forward through the
  plain versions;
* holds every kernel of the training step -- K1, K2, K3 (fused-segment
  backward), K4 (depthwise backward: dx and dk), K5 and K6 (pointwise
  GEMMs with BN sums) -- against its plain version at every X3D-M
  training shape and the training batch (32 clips, per-sample
  coefficient columns) in float32 and bfloat16, and times K3-K6 there
  beside their plain versions and library calls;
* trains X3D-M at full width and depth (16×224², 32 clips, bfloat16,
  SGD-Nesterov) for a few steps, checks the losses and the launches per
  step, checks that two runs of one step from one state are bit-identical,
  and checks one float32 step through the kernels against the same step
  through the plain versions (loss, every gradient, the updated parameters
  and the BN running statistics).

Every result line is a JSON object carrying the card's name and power
limit; the ``kernels`` line comes second to last, and the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time

SEED = 0
CLIPS = 10                    # one X3D-M video: 10 temporal views
TRAIN_CLIPS = 32              # X3D-M's TRAIN.BATCH_SIZE
PARITY_CLIPS = 4              # the float32 kernel-vs-plain training step
TRAIN_STEPS = 4               # step 0 warms up (allocator, cuDNN plans)
MEM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (published)
F32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
BF16_TC_FLOP_PER_S = 989e12   # H100 SXM bfloat16 tensor cores, dense
ITERS = 20

# Tolerances: float32 kernel vs plain float32 (cuDNN without TF32): sums in
# another order, so 1e-4 absolute on activations of order 1, and 1e-5 of a
# column's absolute sum for the per-sample sums.  bfloat16: the kernel
# against the plain version run in float32 on the same bfloat16 inputs, so
# the error is the output's (and, for K2, u's) rounding to bfloat16:
# 2e-2 of the largest |reference|, and of a column's absolute sum.
TOL_F32, TOL_F32_SUMS, TOL_BF16 = 1e-4, 1e-5, 2e-2
TOL_PROBS_F32, TOL_ROW_SUM = 1e-5, 1e-3
# The training kernels' sums (dk, dzs, duu, p, s2) against the plain
# versions' float32 sums: 1e-4 of the same sums over absolute values.
TOL_TRAIN_SUMS = 1e-4
# The float32 training step, kernels vs plain versions at full depth: the
# kernels sum in another order than cuDNN and cuBLAS, so activations differ
# by ~1e-5 relative by the head, and where one sits at a ReLU's or a
# dropout's zero its cotangent flips; through 26 blocks of BN that moves
# the gradients by less than a 1e-6 relative nudge to the input moves the
# plain step itself (on an H100: 1.1% against 2.4% relative L2, recorded
# in PERF.md).  So gradients are compared by norm: over all leaves within
# 5e-2 relative L2, each leaf within 1e-1 relative L2 and cosine >= 0.999.
# The updated parameters likewise against the plain step's update, after
# two float32 ulps of each parameter (a small update is rounded into a
# parameter of order 1).  The loss rtol 1e-5, the running statistics
# (forward only) within 1e-4 of their leaf's largest value.
TOL_STEP_LOSS, TOL_STEP_STATS = 1e-5, 1e-4
TOL_STEP_L2, TOL_STEP_LEAF_L2, TOL_STEP_COS = 5e-2, 1e-1, 0.999


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi unavailable"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import numpy as np
        import torch.nn.functional as F

        from x3d_tpu_torch import variant_config
        from x3d_tpu_torch.data import synthetic_batches
        from x3d_tpu_torch.kernels import _build
        from x3d_tpu_torch.models import build_arch, create_model
        from x3d_tpu_torch.ops import (depthwise, dw_fused, plain_versions,
                                       pw_stats)
        from x3d_tpu_torch.serving import InferenceEngine
        from x3d_tpu_torch.train import create_train_state, make_train_step
    except ImportError as e:
        print(f"chip_smoke: the x3d_tpu_torch package is missing ({e}); "
              "run from the repository root", file=sys.stderr)
        return 2

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card)
    failures = []

    def emit(**kw):
        print(json.dumps({"card": card, **kw}), flush=True)

    def check(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)
            print(f"chip_smoke: FAILED {what}", file=sys.stderr, flush=True)

    def time_ms(fn) -> float:
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / ITERS

    def bound(nbytes: float, flops: float, rate: float = F32_FLOP_PER_S):
        t_mem, t_ops = nbytes / MEM_BYTES_PER_S, flops / rate
        return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                         else "operations")

    # ---------------------------------------------------------- 1. build
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for log in _build.build_logs.values()
             for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit(phase="build", seconds=build_s, sources=list(_build.SOURCES),
         ptxas=ptxas)

    # X3D-M's depthwise shapes at one video, from its architecture plan
    cfg = variant_config("M")
    arch = build_arch(cfg)
    T, S = cfg.DATA.TEMP_DURATION, -(-cfg.DATA.TEST_CROP_SIZE // 2)
    k1_cases = [("conv_1.conv_t", (CLIPS, T, S, S, arch.conv1_dim),
                 (arch.temp_filter, 1, 1), (1, 1, 1),
                 ((arch.temp_filter // 2,) * 2, (0, 0), (0, 0)), 1)]
    k2_cases = []
    for si, blocks in enumerate(arch.stages):
        C = blocks[0].inner_channels
        k1_cases.append((f"stage{si + 2}_block0.b", (CLIPS, T, S, S, C),
                         (arch.temp_kernel, 3, 3), (1, 2, 2), "SAME", 1))
        S = -(-S // 2)
        if len(blocks) > 1:
            k2_cases.append((f"stage{si + 2} stride-1 blocks",
                             (CLIPS, T, S, S, C), len(blocks) - 1))
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def summary(name, route, source, replaces, rows, err=0.0):
        return {"name": name, "route": route, "source": source,
                "replaces": replaces,
                "max_abs_err": max(err, *(r["max_abs_err_f32"]
                                          for r in rows)),
                "ms": sum(r["n"] * r["ms"] for r in rows),
                "plain_ms": sum(r["n"] * r["plain_ms"] for r in rows),
                "bound_ms": sum(r["n"] * r["bound_ms"] for r in rows),
                "bound_by": rows[0]["bound_by"],
                "library_ms": sum(r["n"] * r["library_ms"] for r in rows)}

    # ------------------------------------------- 2. K1 vs its plain version
    k1_rows = []
    for name, shape, kdims, strides, padding, n in k1_cases:
        C = shape[-1]
        x, k = randn(*shape), randn(*kdims, 1, C) * 0.3
        pads = depthwise._resolve_pads(shape, kdims, strides, padding)
        ref = depthwise.depthwise_conv3d_reference(x, k, strides, pads)
        got = depthwise.depthwise_conv3d(x, k, strides, pads)
        torch.cuda.synchronize()
        err32 = (got - ref).abs().max().item()
        xb, kb = x.bfloat16(), k.bfloat16()
        refb = depthwise.depthwise_conv3d_reference(xb.float(), kb.float(),
                                                    strides, pads)
        gotb = depthwise.depthwise_conv3d(xb, kb, strides, pads)
        rel16 = ((gotb.float() - refb).abs().max()
                 / refb.abs().max()).item()
        del x, k, ref, got, refb
        ms = time_ms(lambda: depthwise.depthwise_conv3d(xb, kb, strides,
                                                        pads))
        plain_ms = time_ms(lambda: depthwise.depthwise_conv3d_reference(
            xb, kb, strides, pads))
        # library yardstick: one F.conv3d(groups=C) on the channels-last
        # view; an asymmetric (TF SAME, stride 2) pad is applied beforehand
        xc, w = xb.permute(0, 4, 1, 2, 3), kb.permute(4, 3, 0, 1, 2)
        sym = all(lo == hi for lo, hi in pads)
        if not sym:
            (tl, th), (hl, hh), (wl, wh) = pads
            xc = F.pad(xc, (wl, wh, hl, hh, tl, th)).contiguous(
                memory_format=torch.channels_last_3d)
        lib_pad = tuple(lo for lo, _ in pads) if sym else 0
        library_ms = time_ms(lambda: F.conv3d(xc, w, stride=strides,
                                              padding=lib_pad, groups=C))
        taps = math.prod(kdims)
        nbytes = xb.numel() * 2 + gotb.numel() * 2 + taps * C * 4
        bms, by = bound(nbytes, 2 * taps * gotb.numel())
        row = dict(name=name, shape=list(shape), kernel=list(kdims),
                   strides=list(strides), pads=[list(p) for p in pads], n=n,
                   max_abs_err_f32=err32, rel_err_bf16=rel16, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   library_pre_padded=not sym, bound_ms=bms, bound_by=by)
        emit(phase="K1 depthwise_conv3d", **row)
        check(err32 <= TOL_F32, f"K1 {name} f32 err {err32}")
        check(rel16 <= TOL_BF16, f"K1 {name} bf16 rel err {rel16}")
        k1_rows.append(row)
        del xb, kb, gotb, xc, w
    torch.cuda.empty_cache()

    # ------------------------------------------- 3. K2 vs its plain version
    def sums_err(got, ref, yref):
        scale = yref.abs().sum(dim=(1, 2, 3)).t() if yref is not None \
            else ref.abs()
        return ((got - ref).abs() / scale.clamp_min(1e-30)).max().item()

    k2_rows = []
    for name, shape, n in k2_cases:
        B, C = shape[0], shape[-1]
        x = randn(*shape)
        a = 0.5 + torch.rand((C, B), generator=gen, device="cuda")
        b = 0.3 * randn(C, B)            # about half the offsets are > 0
        k = randn(arch.temp_kernel, 3, 3, 1, C) * 0.3
        y, p, s2 = dw_fused.dw_bn_act_conv(x, a, b, k)
        yr, pr, s2r = dw_fused.reference(x, a, b, k)
        torch.cuda.synchronize()
        err32 = (y - yr).abs().max().item()
        errp32, errs32 = sums_err(p, pr, yr), sums_err(s2, s2r, None)
        xb, kb = x.bfloat16(), k.bfloat16()
        yb, pb, s2b = dw_fused.dw_bn_act_conv(xb, a, b, kb)
        yr, pr, s2r = dw_fused.reference(xb.float(), a, b, kb.float())
        rel16 = ((yb.float() - yr).abs().max() / yr.abs().max()).item()
        errp16, errs16 = sums_err(pb, pr, yr), sums_err(s2b, s2r, None)
        del x, k, y, yr
        ms = time_ms(lambda: dw_fused.dw_bn_act_conv(xb, a, b, kb))
        plain_ms = time_ms(lambda: dw_fused.reference(xb, a, b, kb))
        # library yardstick: the depthwise conv alone, F.conv3d(groups=C)
        u = torch.relu(xb.float() * a.t()[:, None, None, None, :]
                       + b.t()[:, None, None, None, :]).bfloat16()
        uc, w = u.permute(0, 4, 1, 2, 3), kb.permute(4, 3, 0, 1, 2)
        library_ms = time_ms(lambda: F.conv3d(uc, w, padding=1, groups=C))
        taps = arch.temp_kernel * 9
        nbytes = xb.numel() * 4 + 4 * C * B * 4 + taps * C * 4
        bms, by = bound(nbytes, (2 * taps + 5) * xb.numel())
        row = dict(name=name, shape=list(shape), n=n,
                   max_abs_err_f32=err32, p_err_f32=errp32,
                   s2_err_f32=errs32, rel_err_bf16=rel16, p_err_bf16=errp16,
                   s2_err_bf16=errs16, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bms, bound_by=by)
        emit(phase="K2 dw_bn_act_conv", **row)
        check(err32 <= TOL_F32, f"K2 {name} f32 y err {err32}")
        check(max(errp32, errs32) <= TOL_F32_SUMS,
              f"K2 {name} f32 sums err {errp32} {errs32}")
        check(max(rel16, errp16, errs16) <= TOL_BF16,
              f"K2 {name} bf16 err {rel16} {errp16} {errs16}")
        k2_rows.append(row)
        del xb, kb, yb, pb, s2b, u, uc, w
    torch.cuda.empty_cache()

    # ------------------------------------------------ 4. X3D-M serving
    views = cfg.TEST.NUM_TEMPORAL_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    engine1 = InferenceEngine.random_init(cfg, max_videos=1, seed=SEED)
    engine8 = InferenceEngine(cfg, engine1.model, max_videos=8)
    rng = np.random.default_rng(SEED)
    clips8 = rng.integers(0, 256, (8 * views,) + engine1.clip_shape[1:],
                          dtype=np.uint8)
    requests = [("1 video", engine1, clips8[:views]),
                ("8 videos", engine8, clips8),
                ("3 videos (ragged)", engine8, clips8[:3 * views])]
    counters = {"K1": depthwise.depthwise_conv3d,
                "K2": dw_fused.dw_bn_act_conv,
                "K3": dw_fused.dw_bn_act_conv_bwd,
                "K4 dx": depthwise.depthwise_conv3d_dx,
                "K4 dk": depthwise.depthwise_conv3d_dk,
                "K5": pw_stats.pw_conv_stats,
                "K6": pw_stats.pw_act_conv_stats}

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0

    def read_counts():
        return {k: fn.launches for k, fn in counters.items()}

    n_k1 = len(arch.stages) + 1
    n_k2 = sum(len(b) - 1 for b in arch.stages)
    torch.cuda.reset_peak_memory_stats()
    outputs = []
    zero_counts()                            # the serving path starts here
    for name, engine, clips in requests:
        before = read_counts()
        probs = engine.predict(clips)
        after = read_counts()
        outputs.append((name, probs, {k: after[k] - before[k]
                                      for k in after}))
    serve_launches = read_counts()           # ... and ends here
    for name, probs, d in outputs:
        n_videos = probs.shape[0]
        finite = bool(np.isfinite(probs).all())
        row_err = float(np.abs(probs.sum(-1) - 1.0).max())
        emit(phase="serve", request=name, probs_shape=list(probs.shape),
             finite=finite, max_row_sum_err=row_err, k1_launches=d["K1"],
             k2_launches=d["K2"])
        check(probs.shape == (n_videos, cfg.NETWORK.NUM_CLASSES) and finite
              and row_err <= TOL_ROW_SUM, f"serve {name} probabilities")
        want = dict.fromkeys(d, 0) | {"K1": n_k1, "K2": n_k2}
        check(d == want, f"serve {name}: launches {d}, want {want}")
    peak = torch.cuda.max_memory_allocated()

    for name, engine, n_videos in (("1 video", engine1, 1),
                                   ("8 videos", engine8, 8)):
        dev_s = engine.device_latency_s(iters=10)
        clips = clips8[:n_videos * views]
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.predict(clips)
            walls.append(time.perf_counter() - t0)
        emit(phase="serve timing", request=name, clips=n_videos * views,
             device_ms=dev_s * 1e3, clips_per_s=n_videos * views / dev_s,
             wall_ms_median=float(np.median(walls)) * 1e3,
             peak_memory_bytes=peak)

    # float32 forward: kernels vs plain versions, same weights and clips
    engine32 = InferenceEngine(cfg, engine1.model.state_dict(),
                               max_videos=1, dtype=torch.float32)
    del engine8
    torch.cuda.empty_cache()
    p_kernels = engine32.predict(clips8[:views])
    with plain_versions():
        p_plain = engine32.predict(clips8[:views])
    err = float(np.abs(p_kernels - p_plain).max())
    p_bf16 = engine1.predict(clips8[:views])
    emit(phase="serve f32 kernels vs plain", max_abs_err=err,
         bf16_vs_f32_max_abs=float(np.abs(p_bf16 - p_kernels).max()))
    check(err <= TOL_PROBS_F32, f"f32 probs kernels vs plain err {err}")
    del engine1, engine32
    torch.cuda.empty_cache()

    # ------------- 5. K1-K6 at X3D-M's training shapes, and K3-K6's times
    # Every kernel of the training step against its plain version on the
    # same inputs, at the shapes and the batch the step gives it (32 clips,
    # per-sample coefficient columns), in float32 and then bfloat16; the
    # bfloat16 inputs are then timed beside the plain versions and the
    # library calls.
    S = cfg.DATA.TRAIN_CROP_SIZE // 2
    B = TRAIN_CLIPS
    seg_cases, k4_cases = [], [
        ("conv_1.conv_t", (T, S, S, arch.conv1_dim), (arch.temp_filter, 1, 1),
         (1, 1, 1), ((arch.temp_filter // 2,) * 2, (0, 0), (0, 0)), 1)]
    for si, blocks in enumerate(arch.stages):
        k4_cases.append((f"stage{si + 2}_block0.b",
                         (T, S, S, blocks[0].inner_channels),
                         (arch.temp_kernel, 3, 3), (1, 2, 2), "SAME", 1))
        S = -(-S // 2)
        if len(blocks) > 1:
            spec = blocks[1]
            seg_cases.append((f"stage{si + 2} stride-1 blocks", (T, S, S),
                              spec.out_channels, spec.inner_channels,
                              len(blocks) - 1))

    def rel_err(got, ref, scale):
        return ((got.float() - ref.float()).abs()
                / scale.float().clamp_min(1e-30)).max().item()

    def abs_dk(x, g, kdims, strides, pads):
        return depthwise.depthwise_conv3d_dk_reference(
            x.float().abs(), g.float().abs(), kdims, strides, pads)

    def columns(C):
        """Per-sample (C, B) BN coefficient columns: a > 0, about half the
        offsets b > 0."""
        return (0.5 + torch.rand((C, B), generator=gen, device="cuda"),
                0.3 * randn(C, B))

    dtypes = (torch.float32, torch.bfloat16)      # bfloat16 last: timed
    train_err = {"K1": 0.0, "K2": 0.0}

    # K1 forward and K4 (dx, dk): the stem's conv_t and the stage entries
    k4_rows = {"dx": [], "dk": []}
    for name, dims, kdims, strides, padding, n in k4_cases:
        C = dims[-1]
        pads = depthwise._resolve_pads((1, *dims), kdims, strides, padding)
        out = [depthwise._out_size(d, kk, s, p) for d, kk, s, p in
               zip(dims[:3], kdims, strides, pads)]
        errs = {}
        for dtype in dtypes:
            x = randn(B, *dims).to(dtype)
            g = randn(B, *out, C).to(dtype)
            k = (randn(*kdims, 1, C) * 0.3).to(dtype)
            y = depthwise.depthwise_conv3d(x, k, strides, pads)
            ry = depthwise.depthwise_conv3d_reference(x.float(), k.float(),
                                                      strides, pads)
            dx = depthwise.depthwise_conv3d_dx(g, k, x.shape, strides, pads)
            dk = depthwise.depthwise_conv3d_dk(x, g, kdims, strides, pads)
            rdx = depthwise.depthwise_conv3d_dx_reference(
                g.float(), k.float(), x.shape, strides, pads)
            rdk = depthwise.depthwise_conv3d_dk_reference(x, g, kdims,
                                                          strides, pads)
            torch.cuda.synchronize()
            errs[dtype] = ((y.float() - ry).abs().max().item(),
                           rel_err(y, ry, ry.abs().max()),
                           (dx.float() - rdx).abs().max().item(),
                           rel_err(dx, rdx, rdx.abs().max()),
                           rel_err(dk, rdk, abs_dk(x, g, kdims, strides,
                                                   pads)))
            del y, ry, dx, dk, rdx, rdk
        e32, e16 = errs[torch.float32], errs[torch.bfloat16]
        train_err["K1"] = max(train_err["K1"], e32[0])
        emit(phase="K1 depthwise_conv3d, training shape", name=name,
             shape=[B, *dims], max_abs_err_f32=e32[0], rel_err_bf16=e16[1])
        check(e32[0] <= TOL_F32 and e16[1] <= TOL_BF16,
              f"K1 {name} training shape err f32 {e32[0]} bf16 {e16[1]}")
        check(e32[2] <= TOL_F32 and e32[4] <= TOL_TRAIN_SUMS,
              f"K4 {name} f32 err dx {e32[2]} dk {e32[4]}")
        check(e16[3] <= TOL_BF16 and e16[4] <= TOL_TRAIN_SUMS,
              f"K4 {name} bf16 err dx {e16[3]} dk {e16[4]}")
        xc = depthwise._padded_nchw(x, pads).contiguous(
            memory_format=torch.channels_last_3d)
        gc, w = g.permute(0, 4, 1, 2, 3), k.permute(4, 3, 0, 1, 2)

        def cudnn(mask):
            # library yardstick: cuDNN's grouped-conv backward on the
            # channels-last views, the input padded beforehand
            return torch.ops.aten.convolution_backward(
                gc, xc, w, None, list(strides), [0, 0, 0], [1, 1, 1], False,
                [0, 0, 0], C, mask)

        taps = math.prod(kdims)
        ops_ = 2 * taps * g.numel()
        nbytes = (g.numel() + x.numel()) * 2 + taps * C * 4
        for part, kern, plain, mask, err32, err16 in (
                ("dx", lambda: depthwise.depthwise_conv3d_dx(
                    g, k, x.shape, strides, pads),
                 lambda: depthwise.depthwise_conv3d_dx_reference(
                     g, k, x.shape, strides, pads),
                 [True, False, False], e32[2], e16[3]),
                ("dk", lambda: depthwise.depthwise_conv3d_dk(
                    x, g, kdims, strides, pads),
                 lambda: depthwise.depthwise_conv3d_dk_reference(
                     x, g, kdims, strides, pads),
                 [False, True, False], e32[4], e16[4])):
            bms, by = bound(nbytes, ops_)
            row = dict(name=name, shape=[B, *dims], kernel=list(kdims),
                       strides=list(strides), pads=[list(p) for p in pads],
                       n=n, max_abs_err_f32=err32, err_bf16=err16,
                       ms=time_ms(kern), plain_ms=time_ms(plain),
                       library_ms=time_ms(lambda: cudnn(mask)),
                       bound_ms=bms, bound_by=by)
            emit(phase=f"K4 depthwise_conv3d_{part}", **row)
            k4_rows[part].append(row)
        del x, g, k, xc, gc, w
        torch.cuda.empty_cache()

    # K2 forward, K3, K5 and K6 at each stage's stride-1 blocks
    k3_rows, k5_rows, k6_rows = [], [], []
    for name, thw, cout_blk, C, n in seg_cases:
        kdims = (arch.temp_kernel, 3, 3)
        errs = {}
        for dtype in dtypes:
            x = randn(B, *thw, C).to(dtype)
            a, b = columns(C)
            k = (randn(*kdims, 1, C) * 0.3).to(dtype)
            # K2, whose y is K3's and K6's input, as in the step
            y, p, s2 = dw_fused.dw_bn_act_conv(x, a, b, k)
            yr, pr, s2r = dw_fused.reference(x.float(), a, b, k.float())
            e2 = ((y.float() - yr).abs().max().item(),
                  rel_err(y, yr, yr.abs().max()),
                  max(sums_err(p, pr, yr), sums_err(s2, s2r, None)))
            del p, s2, yr, pr, s2r
            gy = randn(B, *thw, C).to(dtype)
            gp, gs2 = 0.1 * randn(C, B), 0.05 * randn(C, B)
            got = dw_fused.dw_bn_act_conv_bwd(x, a, b, k, y, gy, gp, gs2)
            want = dw_fused.bwd_reference(x, a, b, k, y, gy, gp, gs2)
            scales = dw_fused.bwd_abs_sums(x, a, b, k, y, gy, gp, gs2)
            e3 = ((got[0].float() - want[0].float()).abs().max().item(),
                  rel_err(got[0], want[0], want[0].float().abs().max()),
                  max(rel_err(g_, w_, s_) for g_, w_, s_ in
                      zip(got[1:], want[1:], scales)))
            del got, want, scales
            # K5: the block's conv a; K6: its conv c on the segment's output
            xa = randn(B, *thw, cout_blk).to(dtype)
            wa, wc = 0.2 * randn(C, cout_blk), 0.2 * randn(cout_blk, C)
            e56 = []
            for fn, ref, args, absargs in (
                    (pw_stats.pw_conv_stats, pw_stats.pw_conv_stats_reference,
                     (xa, wa), (xa.float().abs(), wa.abs())),
                    (pw_stats.pw_act_conv_stats,
                     pw_stats.pw_act_conv_stats_reference, (y, a, b, wc),
                     (y.float().abs(), a.abs(), b.abs() + 1.0, wc.abs()))):
                yk, pk, sk = fn(*args)
                yr, pr, sr = ref(*args)
                _, pa, sa = ref(*absargs)
                e56.append(((yk.float() - yr.float()).abs().max().item(),
                            rel_err(yk, yr, yr.float().abs().max()),
                            max(rel_err(pk, pr, pa), rel_err(sk, sr, sa))))
                del yk, yr
            torch.cuda.synchronize()
            errs[dtype] = (e2, e3, *e56)
        e32, e16 = errs[torch.float32][0], errs[torch.bfloat16][0]
        train_err["K2"] = max(train_err["K2"], e32[0])
        emit(phase="K2 dw_bn_act_conv, training shape", name=name,
             shape=[B, *thw, C], max_abs_err_f32=e32[0], sums_err_f32=e32[2],
             rel_err_bf16=e16[1], sums_err_bf16=e16[2])
        check(e32[0] <= TOL_F32 and e32[2] <= TOL_F32_SUMS,
              f"K2 {name} training shape f32 err {e32}")
        check(max(e16[1], e16[2]) <= TOL_BF16,
              f"K2 {name} training shape bf16 err {e16}")
        for i, kname in enumerate(("K3", "K5", "K6"), start=1):
            e32, e16 = errs[torch.float32][i], errs[torch.bfloat16][i]
            check(e32[0] <= TOL_F32 and e32[2] <= TOL_TRAIN_SUMS,
                  f"{kname} {name} f32 err {e32}")
            check(e16[1] <= TOL_BF16 and e16[2] <= TOL_TRAIN_SUMS,
                  f"{kname} {name} bf16 err {e16}")

        u = torch.relu(x.float() * a.t()[:, None, None, None, :]
                       + b.t()[:, None, None, None, :]).bfloat16()
        uc, gc = u.permute(0, 4, 1, 2, 3), gy.permute(0, 4, 1, 2, 3)
        w = k.permute(4, 3, 0, 1, 2)
        taps = math.prod(kdims)
        nbytes = 4 * x.numel() * 2 + taps * C * 8 + 6 * C * B * 4
        bms, by = bound(nbytes, (4 * taps + 12) * x.numel())
        e32, e16 = errs[torch.float32][1], errs[torch.bfloat16][1]
        row = dict(
            name=name, shape=[B, *thw, C], n=n, max_abs_err_f32=e32[0],
            sums_err_f32=e32[2], err_bf16=e16[1], sums_err_bf16=e16[2],
            ms=time_ms(lambda: dw_fused.dw_bn_act_conv_bwd(
                x, a, b, k, y, gy, gp, gs2)),
            plain_ms=time_ms(lambda: dw_fused.bwd_reference(
                x, a, b, k, y, gy, gp, gs2)),
            # library yardstick: cuDNN's grouped-conv backward (dx and dk)
            # of the depthwise conv alone, on u and the cotangent
            library_ms=time_ms(lambda: torch.ops.aten.convolution_backward(
                gc, uc, w, None, [1, 1, 1], [1, 1, 1], [1, 1, 1], False,
                [0, 0, 0], C, [True, True, False])),
            bound_ms=bms, bound_by=by)
        emit(phase="K3 dw_bn_act_conv_bwd", **row)
        k3_rows.append(row)
        del gy, u, uc, gc
        for kname, fn, ref, args, mm_in, w_, rows, i in (
                ("K5 pw_conv_stats", pw_stats.pw_conv_stats,
                 pw_stats.pw_conv_stats_reference, (xa, wa), xa, wa,
                 k5_rows, 2),
                ("K6 pw_act_conv_stats", pw_stats.pw_act_conv_stats,
                 pw_stats.pw_act_conv_stats_reference, (y, a, b, wc), y, wc,
                 k6_rows, 3)):
            K, N = w_.shape[1], w_.shape[0]
            M = mm_in.numel() // K
            wb = w_.bfloat16()

            def library():
                # yardstick: torch.matmul, then the per-sample sum pass
                z = torch.matmul(mm_in, wb.t()).float()
                return z.sum(dim=(1, 2, 3)), (z * z).sum(dim=(1, 2, 3))

            nbytes = (M * (K + N) + N * K) * 2 + (2 * N + 2 * K) * B * 4
            bms, by = bound(nbytes, 2 * M * K * N, BF16_TC_FLOP_PER_S)
            e32, e16 = errs[torch.float32][i], errs[torch.bfloat16][i]
            row = dict(name=name, shape=[B, *thw, K], cout=N, n=n,
                       max_abs_err_f32=e32[0], sums_err_f32=e32[2],
                       err_bf16=e16[1], sums_err_bf16=e16[2],
                       ms=time_ms(lambda: fn(*args)),
                       plain_ms=time_ms(lambda: ref(*args)),
                       library_ms=time_ms(library), bound_ms=bms,
                       bound_by=by)
            emit(phase=kname, **row)
            rows.append(row)
        del x, y, xa
        torch.cuda.empty_cache()

    # ----------------------------------------------- 6. X3D-M training
    def snapshot(state):
        return (copy.deepcopy(state.model.state_dict()),
                copy.deepcopy(state.optimizer.state_dict()), state.step)

    def restore(state, snap):
        state.model.load_state_dict(snap[0])
        # the optimizer adopts the tensors it is given (momentum buffers are
        # updated in place), so it gets a copy of the snapshot's
        state.optimizer.load_state_dict(copy.deepcopy(snap[1]))
        state.step = snap[2]

    model = create_model(cfg, dtype=torch.bfloat16, seed=SEED)
    state = create_train_state(cfg, model)
    train_step = make_train_step(model, cfg.NETWORK.WEIGHT_DECAY)
    batch = next(synthetic_batches(cfg, TRAIN_CLIPS, seed=SEED))
    dropout_gen = torch.Generator(device="cuda").manual_seed(SEED)
    want_step = {"K1": n_k1, "K2": n_k2, "K3": n_k2, "K4 dx": n_k1,
                 "K4 dk": n_k1, "K5": n_k2, "K6": n_k2}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    zero_counts()                             # the training path starts here
    for i in range(TRAIN_STEPS):
        before = read_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        state, metrics = train_step(state, batch, dropout_gen)
        end.record()
        end.synchronize()
        wall = time.perf_counter() - t0
        after = read_counts()
        steps.append(dict(step=i, loss=float(metrics["loss"]),
                          device_ms=start.elapsed_time(end), wall_ms=wall * 1e3,
                          launches={k: after[k] - before[k] for k in after}))
    train_launches = read_counts()            # ... and ends here
    train_peak = torch.cuda.max_memory_allocated()
    for s in steps:
        emit(phase="train step", clips=TRAIN_CLIPS, **s)
        check(math.isfinite(s["loss"]), f"train step {s['step']} loss")
        check(s["launches"] == want_step,
              f"train step {s['step']} launches {s['launches']}, "
              f"want {want_step}")
    steady = sorted(s["device_ms"] for s in steps[1:])
    step_ms = steady[len(steady) // 2]
    emit(phase="train timing", clips=TRAIN_CLIPS, steps=TRAIN_STEPS,
         step_ms_median_after_first=step_ms,
         clips_per_s=TRAIN_CLIPS / step_ms * 1e3,
         first_step_ms=steps[0]["device_ms"], peak_memory_bytes=train_peak,
         launches_per_step=want_step)

    # two runs of one step from one state: bit-identical (no atomics in
    # the kernels; cuDNN asked for its deterministic algorithms)
    torch.backends.cudnn.deterministic = True
    snap = snapshot(state)
    runs = []
    for _ in range(2):
        restore(state, snap)
        state, metrics = train_step(state, batch, dropout_gen)
        runs.append((float(metrics["loss"]),
                     [p.grad.clone() for p in model.parameters()],
                     [p.detach().clone() for p in model.parameters()]))
    torch.backends.cudnn.deterministic = False
    same = (runs[0][0] == runs[1][0]
            and all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
            and all(torch.equal(a, b) for a, b in zip(runs[0][2], runs[1][2])))
    emit(phase="train determinism", losses=[r[0] for r in runs],
         bit_identical=same)
    check(same, "two runs of one training step differ")
    del model, state, train_step, batch, runs, snap
    torch.cuda.empty_cache()

    # one float32 step, kernels vs plain versions, same state and batch
    model = create_model(cfg, dtype=torch.float32, seed=SEED + 1)
    state = create_train_state(cfg, model)
    train_step = make_train_step(model, cfg.NETWORK.WEIGHT_DECAY)
    batch = next(synthetic_batches(cfg, PARITY_CLIPS, dtype=torch.float32,
                                   seed=SEED + 1))
    snap = snapshot(state)
    results = []
    for plain in (False, True):
        restore(state, snap)
        zero_counts()
        if plain:
            with plain_versions():
                state, metrics = train_step(state, batch, dropout_gen)
        else:
            state, metrics = train_step(state, batch, dropout_gen)
        torch.cuda.synchronize()
        results.append((float(metrics["loss"]),
                        {n: p.grad.clone()
                         for n, p in model.named_parameters()},
                        copy.deepcopy(model.state_dict()), read_counts()))

    def grad_diff(got, want):
        """(relative L2 over all leaves, worst leaf's relative L2, least
        leaf cosine) of two gradient dicts."""
        num = den = 0.0
        worst, cos = 0.0, 1.0
        for n, w in want.items():
            g = got[n].double().flatten()
            w = w.double().flatten()
            num += (g - w).square().sum().item()
            den += w.square().sum().item()
            worst = max(worst, ((g - w).norm() / w.norm().clamp_min(1e-30))
                        .item())
            cos = min(cos, F.cosine_similarity(g, w, dim=0).item())
        return (num / max(den, 1e-300)) ** 0.5, worst, cos

    def update_diff(got, want):
        """(relative L2 over all leaves, worst leaf's) of the updated
        parameters against the plain step's update, after two float32 ulps
        of each parameter's norm."""
        num = den = 0.0
        worst = 0.0
        for n, _ in model.named_parameters():
            w = want[n].double()
            u = (w - snap[0][n].double()).norm().item()
            d = max((got[n].double() - w).norm().item()
                    - 2.4e-7 * w.norm().item(), 0.0)
            num, den = num + d * d, den + u * u
            worst = max(worst, d / max(u, 1e-30))
        return (num / max(den, 1e-300)) ** 0.5, worst

    (loss_k, grads_k, after_k, n_k), (loss_p, grads_p, after_p, n_p) = \
        results
    g_l2, g_leaf, g_cos = grad_diff(grads_k, grads_p)
    u_l2, u_leaf = update_diff(after_k, after_p)
    stats_err = max((after_k[n] - v).abs().max().item() / v.abs().max().item()
                    for n, v in after_p.items()
                    if n.endswith((".mean", ".var")))
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    emit(phase="train f32 kernels vs plain", clips=PARITY_CLIPS,
         loss_kernels=loss_k, loss_plain=loss_p, loss_rel_err=loss_err,
         grad_rel_l2=g_l2, grad_worst_leaf_rel_l2=g_leaf,
         grad_least_leaf_cosine=g_cos, update_rel_l2=u_l2,
         update_worst_leaf_rel_l2=u_leaf,
         stats_err_of_leaf_max=stats_err,
         kernel_launches=n_k, plain_launches=n_p)
    check(loss_err <= TOL_STEP_LOSS, f"f32 step loss err {loss_err}")
    check(g_l2 <= TOL_STEP_L2 and g_leaf <= TOL_STEP_LEAF_L2
          and g_cos >= TOL_STEP_COS,
          f"f32 step grads: rel L2 {g_l2}, worst leaf {g_leaf}, "
          f"least cosine {g_cos}")
    check(u_l2 <= TOL_STEP_L2 and u_leaf <= TOL_STEP_LEAF_L2,
          f"f32 step update: rel L2 {u_l2}, worst leaf {u_leaf}")
    check(stats_err <= TOL_STEP_STATS, f"f32 step stats err {stats_err}")
    check(n_k == want_step and set(n_p.values()) == {0},
          f"f32 step launches kernels {n_k} plain {n_p}")
    del model, state, results
    torch.cuda.empty_cache()

    # ------------------------------------------------ 7. the kernel line
    csrc = "x3d_tpu_torch/kernels/csrc/"
    entries = [
        (summary("depthwise_conv3d", "cuda", csrc + "depthwise.cu",
                 "x3d_tpu/ops/dw_batchminor.py:101, "
                 "x3d_tpu/ops/pallas_dw.py:97", k1_rows, train_err["K1"]),
         "K1", "serve"),
        (summary("dw_bn_act_conv", "cuda", csrc + "dw_fused.cu",
                 "x3d_tpu/ops/dw_fused.py:298", k2_rows, train_err["K2"]),
         "K2", "serve"),
        (summary("dw_bn_act_conv_bwd", "cuda", csrc + "dw_fused_bwd.cu",
                 "x3d_tpu/ops/dw_fused.py:346", k3_rows), "K3", "train"),
        (summary("depthwise_conv3d_dx", "cuda", csrc + "depthwise_bwd.cu",
                 "x3d_tpu/ops/dw_batchminor.py:231 (dx by _fwd_kernel), "
                 "x3d_tpu/ops/pallas_dw.py:221 (dx by _fwd_kernel)",
                 k4_rows["dx"]), "K4 dx", "train"),
        (summary("depthwise_conv3d_dk", "cuda", csrc + "depthwise_bwd.cu",
                 "x3d_tpu/ops/dw_batchminor.py:120, "
                 "x3d_tpu/ops/pallas_dw.py:123", k4_rows["dk"]), "K4 dk",
         "train"),
        (summary("pw_conv_stats", "cuda", csrc + "pw_stats.cu",
                 "x3d_tpu/ops/pw_batchminor.py:132", k5_rows), "K5",
         "train"),
        (summary("pw_act_conv_stats", "cuda", csrc + "pw_stats.cu",
                 "x3d_tpu/ops/pw_batchminor.py:260", k6_rows), "K6",
         "train"),
    ]
    kernels_line = []
    for entry, key, path in entries:
        entry["launches"] = (serve_launches if path == "serve"
                             else train_launches)[key]
        entry["path"] = "X3D-M serving" if path == "serve" \
            else f"X3D-M training, {TRAIN_STEPS} steps"
        entry["launches_serving"] = serve_launches[key]
        entry["launches_training"] = train_launches[key]
        check(entry["launches"] > 0,
              f"{entry['name']} never launched on its main path")
        kernels_line.append(entry)
    print(json.dumps({"card": card, "kernels": kernels_line}))
    if failures:
        fail(f"{len(failures)} check(s) failed: {failures}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
