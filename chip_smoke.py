#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and command-line paths on one
CUDA card.

Run from the repository root, on a machine with one NVIDIA H100 and the
CUDA toolkit::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``x3d_tpu_torch/kernels/csrc`` (one
nvcc per source, in parallel; ptxas's registers, spills and static shared
memory of each instantiation of K5-K7's pipelined tensor-core body, K7's
Hopper (wg) body, K4 dx's phase body, K4 dk's ring body, K1's temporal and
ring bodies, K3's and K2's ring bodies, K8's temporal body and K7's pipe
and wg bodies built with the BN epilogue on a line of its own, which fails
on a spill where the body must not spill) and then:

* holds the serving kernels K1 (depthwise conv) and K2 (fused BN+ReLU ->
  depthwise -> sums) against their plain PyTorch versions at every X3D-M
  and X3D-S serving shape, in requests of 1 and 8 videos (10 and 80
  clips; X3D-S's eval batch is 80 too), float32 and bfloat16, and times
  kernel, the library's ``F.conv3d(groups=C)`` and, at one X3D-M video,
  the plain version; each call also with the eval BatchNorm after it as its
  epilogue (random running statistics; the stem's with the ReLU), as
  serving launches it, checked and timed (``epilogue_ms``); each row names
  the body that ran (K1: the temporal
  body at the stem, the ring body at the stride-2 stage entries; K2: the
  ring body at every fused segment), its plan and the generic body's time
  on the same inputs; K1's rows fail where the body is behind the generic
  body, the plain version or the library;
* serves X3D-M at full width (16×224², 10 views, bfloat16, random weights
  from a seed) through ``InferenceEngine``, checks the probabilities and
  that each forward launched K1 5 times (once by its temporal body, four
  times by its ring body) and K2 22 times (all by its ring body), with
  every BatchNorm as an epilogue (K7 30 and 5 with the ReLU, K2 22, K1 4
  and 1 with the ReLU), and
  checks one float32 forward through the kernels against the same forward
  through the plain versions;
* holds every kernel of the training step -- K1, K2, K3 (fused-segment
  backward), K4 (depthwise backward: dx and dk), K5 and K6 (pointwise
  GEMMs with BN sums) -- against its plain version at every X3D-M
  training shape and the training batch (32 clips, per-sample
  coefficient columns) in float32 and bfloat16, and times K2-K6 there
  beside their plain versions and library calls; then the same at X3D-S's
  training shapes (64 clips of 13 frames; 40², 20², 10², 5² planes); K1's
  rows there carry the same fields as in serving and are summed per step;
  K4's
  dx rows name the body that ran (the parity-phase body at the stride-2
  stage entries, the gather body elsewhere) and time the gather body on the
  same inputs beside the phase body; its dk rows name theirs (the ring body
  at the stride-2 stage entries, the generic body at the stem, which K8
  takes in the step) and time the generic body on the same inputs, and a
  ring row fails where it is behind the generic body, the plain version or
  cuDNN's weight gradient; K2's and K3's rows likewise name
  their body (the ring body at every fused segment), carry the ring body's
  launch plan and time the generic body on the same inputs;
  K5-K7's rows carry how the call runs (copy granule, block columns, ring
  stages, shared memory, blocks per SM), ``bound_share`` (bound / time)
  and ``vs_library`` (time / library time), and K2, K5 and K6 are summed
  over each variant's training step;
* trains X3D-M at full width and depth (16×224², 32 clips, bfloat16,
  SGD-Nesterov) for a few steps, checks the losses and the launches per
  step (K1 by its temporal and ring bodies only, K4 dx by its phase body
  only, K4 dk, K2 and K3 by their ring bodies only, K8 by its temporal
  body only),
  checks that two runs of one step from one state are bit-identical, and
  checks one float32 step through the kernels against the same step
  through the plain versions (loss, every gradient, the updated parameters
  and the BN running statistics);
* holds K7 (the plain 1x1x1 conv as a GEMM: float32 on the CUDA cores,
  bfloat16 on its Hopper wg body or the pipelined tensor-core body it
  shares with K5 and K6, as ``pointwise.pw_body`` names) against its plain
  version and times it beside ``F.linear`` and the pipe body at every bulk
  1x1x1 conv of X3D-M and X3D-S (serving requests of 10 and 80 clips,
  training at 32 and 64 clips), forward and dx, the serving calls also
  with their BatchNorm (and ReLU) as the epilogue; takes each case's device
  time for K7, each body and ``F.linear`` (``tools/profile_pointwise``:
  the profiler's, or CUDA events with the stream held where the profiler
  loses part of a case's window three times),
  failing where the wg body is behind the pipe body by more than 3%, the
  host's time to launch each body, and K7's and ``F.linear``'s device time
  over the 57 launches of an X3D-M 10-clip forward with
  ``torch.profiler``; the serving path, the X3D-M step and the X3D-S tool
  run check that every K7 launch ran the body its plan names;
* holds K8 (the depthwise conv's one-pass backward) against its plain
  version and against K4's dx and dk at the stems of X3D-M and X3D-S and
  at a 3x3x3 stage-2 shape, with the times of all three and of cuDNN;
  each row names the body that ran (the temporal body at the stems, the
  generic body at 3x3x3) and its plan, and times the generic body on the
  same inputs; a temporal row fails where it is behind the generic body,
  the plain version or cuDNN; the X3D-M step and the X3D-S tool run check
  that every K8 launch took the temporal body;
* holds K9 (the multiply-add chain) against its plain version and runs the
  probe tool: the float32 and packed-bfloat16 rates and their share of the
  card's peak;
* drives the command-line tools at X3D-S full width and depth (13×160², 64
  clips, bfloat16), in this process through their ``main(argv)``: train two
  epochs of three steps with step-keyed checkpoints (K1 by its new bodies
  only, K4 dk, K2 and K3 by their ring bodies only, K8 by its temporal
  body only), resume for a third
  epoch (the
  restored step is 6 and
  the losses equal an uninterrupted run's, bit for bit, with cuDNN's flags
  as the tools set them), evaluate two batches of 8 videos × 10 views, and
  serve one video from the checkpoint;
* takes X3D-XS (4×160², 128 training clips, 10 views), X3D-L and X3D-XL
  (16×312², 16 training clips, 3 views) from their YAMLs at full width
  and depth, bfloat16: holds every kernel against its plain version at
  the shapes their serving requests (1 and 8 videos) and training steps
  give it, float32 and bfloat16, with fewer timing repeats (a row on the
  path fails where the kernel is behind its plain version, or a new body
  behind the generic body where that takes 0.15 ms or more; K7's plain
  version is its library call, ``F.linear``, so its rows behind it are
  recorded, not failed); serves 1 and 8 videos through ``InferenceEngine``
  (probabilities, device and wall ms, peak memory, launches and bodies per
  forward); trains
  the bare step for a few steps at the config's batch (first and median
  ms, clips/s, peak memory, launches and bodies per step), L and XL with
  remat as ``create_model`` resolves it from the YAML ("auto": per block),
  without, and with "convs" (the conv outputs kept: K1, K2, K5, K6 and K7
  launch as without remat, no conv again in the backward), and checks
  that one step repeats bit for bit and that the steps with remat "block"
  and "convs" equal the step without, bit for bit (loss, gradients,
  parameters, running statistics); and checks a float32 step through the
  kernels against the plain versions for XS (whose stem's 4 frames are
  fewer than its 5 taps, so K4 takes its backward) and XL (SCALE_RES2,
  widths 2 mod 4);
* reads real input (phase 11b: TFRecord shards written on the card,
  nvJPEG and the clip kernel);
* checks the time-folded layout's surface (phase 11e, ``time_fold``; the
  port runs one body for every layout): K1 through
  ``depthwise_conv3d_folded`` at X3D-M's 1-video request, and the engine's
  five settings, each serving that request bit for bit with the same
  launches.  ``--fold-only`` runs the build and this phase alone;
* trains X3D-M by long-cycle multigrid (phase 11c) through ``tools/train
  --multigrid --synthetic`` at full width and depth: the default factors
  over 5 epochs of 8 base steps (23 steps at 256 x 4x160², 128 x 8x160²,
  64 x 8x224² and 32 x 16x224²), each step's batch at its phase's shape,
  every loss finite, each epoch's launches by body (phase 0's 4 frames are
  fewer than the stem's 5 taps: K4's gather and generic bodies take its
  backward), a crash after the checkpoint inside phase 1 resumed to the
  uninterrupted run's final state bit for bit; per phase the bare step's
  median, clips/s, peak memory, the device's idle share and the stem
  backward's route and time; a float32 step through the kernels against
  the plain versions at each phase's full batch; one bfloat16 step at each
  X3D-S and X3D-XS phase shape (XS: down to 1024 clips of 1x112²); the
  tool on the phase-11b shards with validation and precise BN; and
  ``tools/bench_multigrid --variant=M`` (its JSON line).
  ``--multigrid-only`` runs the build, the shards and this phase alone;
* imports the reference's TF checkpoint format (phase 11d): every variable
  of X3D-M at full width and depth (random float32 from the seed) written
  with numpy in the reference's variable paths and TF's tensor-bundle
  format, with momentum slots, a save counter and the object graph; the
  import tool (``--verify_only``, then into a model folder) and
  ``tools/predict`` on that folder, each as a process of its own; every
  restored leaf bit for bit the array written, a bfloat16 1-video request
  (K1 5, K2 22, K7 57 launches), a float32 forward through the kernels
  against the plain versions on the imported weights, and ``tools/summary
  --variant M`` against ``model_summaries/X3D_M.txt`` byte for byte; the
  import tool's wall time and the bundle's size.  ``--import-only`` runs
  the build and this phase alone;
* trains across processes (phase 12): X3D-M's float32 step with per-replica
  BN statistics (``bn_groups`` 2, per-sample coefficient columns through
  K2, K3, K5 and K6) against the plain versions; the bfloat16 step at 32
  clips with ``bn_groups`` 1 (synced), 2 and 4 -- launches and bodies per
  step, bit for bit repeated, step ms, peak memory and idle share side by
  side; two gloo ranks sharing the card (spawned processes) with
  ``SYNC_BN`` on and off and with the head split over a model axis of 2,
  each against the one-process step, every rank's parameters bit for bit
  alike; and ``tools/train`` at X3D-S in a one-rank NCCL group against the
  same run without a process group, bit for bit.  ``--parallel-only`` runs
  the build and this phase alone;
* exports the serving forward (phase 13): ``tools/export`` writes X3D-M
  (full width and depth, random weights from the seed) in float32 and
  bfloat16, with the ``x3d::`` kernel ops and ``--portable``, each as a
  process of its own; each ``serve_videos`` program is loaded in a fresh
  process and serves 1 and 8 videos: the default programs bit for bit the
  engine's probabilities at the same batch, K1 5, K2 22 and K7 57
  launches a forward by the planned bodies, the portable ones no launch
  and within 1e-4 (float32) of the plain forward; device and wall ms
  beside the engine's, the export's and the load's wall seconds, the
  files' bytes; a tiny program traced on the CPU moved onto the card; the
  host's microseconds a call of each op against a direct call.
  ``--export-only`` runs the build and this phase alone;
* reads raw videos (phase 14): 16 coded videos written as Motion-JPEG AVIs
  on the card (nvJPEG; 4 classes in a class-per-folder tree, 30 fps, 12 s
  and 10 s in turn, one with an OpenDML continuation, one without Huffman
  tables), ``tools/create_label`` (the tree; a flat directory through an
  annotations JSON and the Kinetics-400 map), ``tools/create_tfrecords``
  (the first 10 s of each) and ``tools/inspect_tfrecords`` as processes;
  X3D-M trained at 32 clips and evaluated at 10 views from the text list
  (nvJPEG and the clip kernel, launches counted), the clips against the
  plain clip prep bit for bit and the sampled frames' codes against the
  sampler's indices, the list's eval against the shards' in labels and
  order (and the probabilities' gap); ``tools/train --nouse_tfrecord`` and
  ``tools/eval --notfrecord``; the loader on the list against the shards
  and a thread's record by stage; no video given as zeros.
  ``--videos-only`` runs the build and this phase alone.
* runs the developer tools (phase 15), each through its entry point:
  ``tools/memory`` at X3D-L (16 clips, remat off, block, stage and convs:
  the measured peaks ordered block < convs < off, and off, block and convs
  within 2% of phase 11's peaks of the same steps, both above what the
  process held before the model was built); ``tools/ab`` at X3D-M
  (32 clips through the kernels and through their plain versions, the
  kernels ahead; a 1-video eval); ``tools/profile`` on two X3D-M training
  steps at 32 clips, ``--analyze_only`` on its directory (the same text)
  and ``tools/roofline`` on it (exit 0: no kernel above 1.05 of its bound):
  K1-K8's launches a step equal to the launch counters' and their bound a
  step, from the wrappers' launch log, within 1% of PERF.md's.
  ``--tools-only`` runs the build and this phase alone.

Every result line is a JSON object carrying the card's name and power
limit (a phase's rows also ``t_s``, the seconds since the script found
the card); the ``kernels`` line comes second to last, and the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import logging
import math
import os
import re
import subprocess
import sys
import tempfile
import time

SEED = 0
CLIPS = 10                    # one X3D-M video: 10 temporal views
TRAIN_CLIPS = 32              # X3D-M's TRAIN.BATCH_SIZE
PARITY_CLIPS = 4              # the float32 kernel-vs-plain training step
TRAIN_STEPS = 4               # step 0 warms up (allocator, cuDNN plans)
S_TRAIN_CLIPS = 64            # X3D-S's TRAIN.BATCH_SIZE
S_EVAL_CLIPS = 80             # X3D-S's TEST.BATCH_SIZE: 8 videos x 10 views
MEM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (published)
F32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
BF16_TC_FLOP_PER_S = 989e12   # H100 SXM bfloat16 tensor cores, dense
ITERS = 20
NEW_ITERS = 5                 # timing repeats in the X3D-XS/L/XL phase
HOST_BOUND_MS = 0.15          # time_fn below this reads the host's gaps
NEW_VARIANTS = ("XS", "L", "XL")

# Tolerances: float32 kernel vs plain float32 (cuDNN without TF32): sums in
# another order, so 1e-4 absolute on activations of order 1, and 1e-5 of a
# column's absolute sum for the per-sample sums.  bfloat16: the kernel
# against the plain version run in float32 on the same bfloat16 inputs, so
# the error is the output's (and, for K2, u's) rounding to bfloat16:
# 2e-2 of the largest |reference|, and of a column's absolute sum.
TOL_F32, TOL_F32_SUMS, TOL_BF16 = 1e-4, 1e-5, 2e-2
# K7 sums K <= 432 products in float32 in another order than the library:
# float32 within 1e-5 of the largest |y|; bfloat16 (against the float32
# product of the same bfloat16 inputs) within one bfloat16 ulp of the
# largest |y|, 2^-7 (half an ulp is up to 2^-8 of a value just above a
# power of two; measured up to 3.8e-3).  K8's du likewise (TOL_F32, TOL_BF16) and its dk within
# TOL_TRAIN_SUMS of the sums over absolute values; against K4 on the same
# inputs du within one rounding and dk within 1e-6 of those sums.  K9's
# chain against the plain chain (each step rounded once): 1e-6 in float32,
# one bfloat16 ulp at 0.5 (2^-8) in bfloat16.
TOL_K7_F32, TOL_K7_BF16 = 1e-5, 2.0 ** -7
# A call with the BN epilogue (K1, K2, K7 at the serving shapes, an eval
# BatchNorm from random running statistics): bit for bit the same kernel
# without it through the plain epilogue (``ops.epilogue.reference``), and
# within TOL_F32 / TOL_BF16 of the largest |reference| of the plain conv in
# float32 through the plain epilogue (a wrong coefficient or a missing ReLU
# is off by the order of the values).
TOL_K8_VS_K4_DK = 1e-6
TOL_K9_F32, TOL_K9_BF16 = 1e-6, 2.0 ** -8
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
# (forward only) within 1e-4 of their leaf's largest value.  X3D-XS and
# X3D-XL (55 blocks) are held to the larger of these bounds and what a
# 1e-6 relative nudge of each input value moves the plain step by,
# measured in the same run (f32_step_check's ``calibrate``).
TOL_STEP_LOSS, TOL_STEP_STATS = 1e-5, 1e-4
TOL_STEP_L2, TOL_STEP_LEAF_L2, TOL_STEP_COS = 5e-2, 1e-1, 0.999


# Multigrid phase: X3D-M's default long cycle over 5 epochs of 8 base steps
# (23 steps: 1, 2, 4, 8 and 8 at batches 256, 128, 64, 32); bare steps
# timed a phase after one warm-up step; bench_multigrid's chained steps a
# round; the shard run at an eighth of the batches (the loader fills a
# reservoir of 16 batches of records a phase).
MG_BASE_STEPS, MG_EPOCHS = 8, 5
MG_TIMED_STEPS = 3
MG_BENCH_STEPS = 5
MG_SHARD_BATCH = 4


# Phase 12: the bfloat16 X3D-M step by bn_groups (1 = synced, first and
# last), timed steps after one warm-up; two gloo ranks sharing the card:
# (name, data, model, SYNC_BN, dropout on, the one-process step's
# bn_groups they are held against).
PAR_GROUPS = (1, 2, 4, 1)
PAR_TIMED_STEPS = 5
PAR_RUNS = (("sync", 2, 1, True, False, 1),
            ("grouped", 2, 1, False, False, 2),
            ("head split", 1, 2, True, True, 1))
PAR_RANK_TIMEOUT_S = 300


# Input phase: shard geometry (Kinetics frame sizes) and its thresholds.
INPUT_VIDEOS = 16             # 4 shards of 4 videos, 300 frames each
INPUT_FRAMES = 300            # 10 s at 30 fps: what the JAX writer keeps
INPUT_SIZES = ((256, 340), (340, 256), (240, 320))   # (height, width)
# nvJPEG's encode and decode of the frames (quality 90, 4:2:0) against
# the frames written, in levels: the mean over 30 frames' values and the
# largest value.  Measured on an H100: means 1.81-1.87, largest 13-14, at
# the codes' sharp black/white edges.
TOL_JPEG_MEAN = 3.0
TOL_JPEG_MAX = 32
INPUT_TIMED_STEPS = 6         # step medians, after one warm-up step


def input_videos():
    """The input phase's videos: their labels and (height, width)s."""
    labels = [(37 * i + 5) % 400 for i in range(INPUT_VIDEOS)]
    sizes = [INPUT_SIZES[i % 3] for i in range(INPUT_VIDEOS)]
    return labels, sizes


def write_input_shards(emit, check, d) -> str:
    """Write the input phase's coded videos into 4 GZIP shards in ``d`` on
    the card (nvJPEG); returns their file pattern."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from x3d_tpu_torch.data import tfrecords
    from x3d_tpu_torch.data.synthetic import coded_video
    from x3d_tpu_torch.ops import jpeg

    dev = torch.device("cuda")
    labels, sizes = input_videos()
    t0 = time.perf_counter()

    def write(s):
        ids = range(4 * s, 4 * s + 4)
        return tfrecords.write_shard(
            os.path.join(d, f"train-{s:05d}.tfrecord"),
            (tfrecords.frames_to_sequence_example(
                coded_video(INPUT_FRAMES, *sizes[i], labels[i], seed=i),
                labels[i]) for i in ids), device=dev)

    with ThreadPoolExecutor(4) as pool:
        written = sum(pool.map(write, range(INPUT_VIDEOS // 4)))
    write_s = time.perf_counter() - t0
    shard_bytes = sum(os.path.getsize(os.path.join(d, f))
                      for f in os.listdir(d))
    emit(phase="input: shards written on the card", videos=written,
         frames=INPUT_FRAMES, sizes=[list(s) for s in INPUT_SIZES],
         seconds=write_s, shard_mb=shard_bytes / 2**20,
         nvjpeg_backend=jpeg.device_codec(dev).backend,
         nvjpeg_refused=jpeg.device_codec(dev).refused)
    check(written == INPUT_VIDEOS, f"wrote {written} videos")
    return os.path.join(d, "train-*")


def read_back(plan, cfg, training: bool, frames_of) -> bool:
    """Codes of every clip frame's decoded frame (``data.synthetic
    .read_code``) against its record's sampled index and label, and each
    record's indices against the sampler's formula over ``frames_of(
    record)`` frames."""
    import numpy as np

    from x3d_tpu_torch.data.synthetic import read_code

    T = cfg.DATA.TEMP_DURATION
    views = 1 if training else cfg.TEST.NUM_TEMPORAL_VIEWS
    ok = True
    clip = 0
    for r in plan.records:
        crops = len(r.maps)
        size = frames_of(r)
        if training:
            k = np.arange(T)
            ok &= bool(np.array_equal(
                r.indices, (r.indices[0] + k * cfg.DATA.FRAME_RATE) % size))
        else:
            rate = max(1, size // T)
            ok &= bool(np.array_equal(
                r.indices, (np.arange(views * T) * rate) % size))
        for c in range(crops):
            for m in range(views * T):
                off = int(plan.table[clip]["src"])
                img = plan.arena[off:off + r.height * r.width * 3] \
                    .view(r.height, r.width, 3)
                idx, lab = read_code(img).tolist()
                ok &= idx == int(r.indices[m]) and lab == r.label
                clip += 1
    return ok


def input_phase(emit, check, shard_dir=None):
    """Phase 11b: real input data.  Writes TFRecord shards of coded 300-frame
    videos on the card (nvJPEG, GZIP 9), checks nvJPEG's round trip, holds
    the clip kernel against its plain version bit for bit on the decoded
    frames of the loader's own batches (X3D-M training and eval, a 3-crop
    eval, X3D-S training), reads the sampled frames' codes back, trains and
    evaluates X3D-M at full width from the shards (its clip and decode
    launches counted over that run), drives the X3D-S tools on the shards,
    and measures the loader alone (at its own reservoir, the fill timed
    apart) and a thread's record by stage, the shard-fed step against
    synthetic input and against the synthetic step with the loader's host
    work beside it, and the decode and clip kernel's device time.  Returns
    the clip kernel's entry of the ``kernels`` line.  The loader prepares a
    batch ahead, so its launches over the training run count one more batch
    than the steps.  The shards are written into ``shard_dir`` and left
    there where it is given (the multigrid phase reads them), else into a
    directory of its own that it removes."""
    import os
    import statistics

    import numpy as np
    import torch

    from x3d_tpu_torch import variant_config
    from x3d_tpu_torch.data import InputReader, synthetic_batches, tfrecords
    from x3d_tpu_torch.data.synthetic import coded_video, read_code
    from x3d_tpu_torch.models import create_model
    from x3d_tpu_torch.ops import clip_prep, jpeg
    from x3d_tpu_torch.tools import bench_loader
    from x3d_tpu_torch.tools import eval as eval_cli
    from x3d_tpu_torch.tools import predict as predict_cli
    from x3d_tpu_torch.tools import train as train_cli
    from x3d_tpu_torch.tools.trace import family, trace
    from x3d_tpu_torch.train import (create_train_state, make_eval_step,
                                     make_train_step)

    dev = torch.device("cuda")
    labels, sizes = input_videos()
    work = None if shard_dir else tempfile.TemporaryDirectory(
        prefix="chip_smoke_input_")
    d = shard_dir or work.name
    try:
        pattern = write_input_shards(emit, check, d)

        # --------------------------------------------- nvJPEG's round trip
        recs = tfrecords.read_shard(os.path.join(d, "train-00000.tfrecord"),
                                    jpeg.crc32c)
        trip = []
        for i in range(3):
            view = tfrecords.SequenceExampleView(recs[i])
            h, w = sizes[i]
            picks = list(range(0, INPUT_FRAMES, 10))
            arena, offs = jpeg.decode_batch(
                [bytes(view.frame(k)) for k in picks], [(h, w)] * len(picks),
                dev)
            got = torch.stack([arena[o:o + h * w * 3].view(h, w, 3)
                               for o in offs])
            want = coded_video(INPUT_FRAMES, h, w, labels[i], seed=i)[picks]
            err = (got.int() - want.int()).abs()
            trip.append({"size": [h, w], "frames": len(picks),
                         "mean_err": float(err.float().mean()),
                         "max_err": int(err.max()),
                         "codes_ok": bool((read_code(got)[:, 0].cpu()
                                           == torch.tensor(picks)).all())})
        emit(phase="input: nvJPEG round trip", rows=trip,
             tol_mean=TOL_JPEG_MEAN, tol_max=TOL_JPEG_MAX)
        check(all(r["mean_err"] <= TOL_JPEG_MEAN
                  and r["max_err"] <= TOL_JPEG_MAX and r["codes_ok"]
                  for r in trip), f"nvJPEG round trip: {trip}")

        # ---------------------- the clip kernel against its plain version
        def config(v, crops=1):
            c = variant_config(v)
            c.TEST.NUM_SPATIAL_CROPS = crops
            return c

        def loader_batch(cfg, training, batch, seed=SEED):
            reader = InputReader(cfg, training, seed=seed)
            reader.keep_last = True
            it = reader(pattern, batch)
            out = next(it)
            it.close()
            return out, reader.last, cfg

        cases = []
        worst_err = 0.0
        for name, v, training, batch, crops in (
                ("X3D-M training", "M", True, 32, 1),
                ("X3D-M eval, 10 views", "M", False, 4, 1),
                ("X3D-M eval, 3 crops", "M", False, 2, 3),
                ("X3D-S training", "S", True, 64, 1)):
            out, plan, cfg = loader_batch(config(v, crops), training, batch)
            T = cfg.DATA.TEMP_DURATION
            S = cfg.DATA.TRAIN_CROP_SIZE if training \
                else cfg.DATA.TEST_CROP_SIZE
            shape = (len(plan.table) // T, T, S, S, 3)
            args = (plan.arena, plan.table, shape)
            norm = (cfg.DATA.MEAN, cfg.DATA.STD)
            u8 = clip_prep.clip_prep(*args, torch.uint8)
            u8_ref = clip_prep.clip_prep_reference(*args, torch.uint8)
            ref = clip_prep.clip_prep_reference(*args, torch.bfloat16, *norm)
            same_u8 = torch.equal(u8, u8_ref)
            same = torch.equal(out["video"], ref)
            err = float((out["video"].float() - ref.float()).abs().max())
            worst_err = max(worst_err, err)
            flips = sorted({int(f) for f in plan.table["flip"]})
            codes = read_back(plan, cfg, training,
                              lambda r: INPUT_FRAMES) \
                and {r.label for r in plan.records} <= set(labels)
            plain_ms = statistics.median(
                _wall_ms(lambda: clip_prep.clip_prep_reference(
                    *args, torch.bfloat16, *norm)) for _ in range(3))
            summary = trace(lambda: clip_prep.clip_prep(
                *args, torch.bfloat16, *norm), n=5, unit="call",
                group=lambda n: "clip" if "clip_prep_kernel" in n
                else family(n))
            ms = summary["group_ms_per_call"].get("clip", 0.0)
            nbytes = clip_prep.bound_bytes(plan.table, shape, torch.bfloat16)
            flops = 12 * int(np.prod(shape))
            bound_ms = max(nbytes / MEM_BYTES_PER_S, flops / F32_FLOP_PER_S) \
                * 1e3
            row = {"case": name, "clips": shape[0], "shape": list(shape),
                   "decoded_frames": len(plan.offsets),
                   "bit_for_bit_uint8": same_u8,
                   "bit_for_bit_bf16": same, "max_abs_err": err,
                   "flips": flips, "codes_read_back": codes, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": "bytes" if nbytes / MEM_BYTES_PER_S
                   >= flops / F32_FLOP_PER_S else "operations",
                   "bound_bytes": nbytes}
            cases.append(row)
            emit(phase="input: clip kernel vs plain", **row)
            check(same_u8 and same, f"clip kernel differs from its plain "
                                    f"version: {name}")
            check(codes, f"input: sampled frames' codes wrong: {name}")
            if training and v == "M":
                check(flips == [0, 1], f"X3D-M training flips {flips}")
            del out, plan, u8, u8_ref, ref

        # ---------------- X3D-M training and eval from the shards (counted)
        cfg_m = variant_config("M")
        model = create_model(cfg_m, seed=SEED)
        state = create_train_state(cfg_m, model)
        step_fn = make_train_step(model, cfg_m.NETWORK.WEIGHT_DECAY)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        reader = InputReader(cfg_m, True, seed=SEED)
        it = reader(pattern, 32)
        clip_prep.clip_prep.launches = 0
        jpeg.decode_batch.launches = 0
        losses = []
        for _ in range(TRAIN_STEPS):
            state, metrics = step_fn(state, next(it), gen)
            losses.append(float(metrics["loss"]))
        it.close()      # waits for the batch prepared ahead of the last
        torch.cuda.synchronize()
        launches = {"clip_prep": clip_prep.clip_prep.launches,
                    "nvjpeg_decode": jpeg.decode_batch.launches}
        eval_reader = InputReader(cfg_m, False)
        eval_step = make_eval_step(model)
        eval_batch = next(eval_reader(pattern, cfg_m.TEST.BATCH_SIZE))
        ev = eval_step(state, eval_batch)
        ev = {k: float(v) for k, v in ev.items()}
        emit(phase="input: X3D-M trained and evaluated from shards",
             clips=32, steps=TRAIN_STEPS, losses=losses, launches=launches,
             eval_clips=int(eval_batch["video"].shape[0]), eval=ev)
        check(all(math.isfinite(x) for x in losses)
              and all(math.isfinite(x) for x in ev.values())
              and launches == {"clip_prep": TRAIN_STEPS + 1,
                               "nvjpeg_decode": TRAIN_STEPS + 1}
              and eval_batch["video"].shape[0] == 40,
              f"X3D-M from shards: {losses} {ev} {launches}")

        # ------------------- step median: shards against synthetic input
        synth = next(synthetic_batches(cfg_m, 32, seed=SEED))
        it = reader(pattern, 32)

        def step_times(next_batch):
            """Step ms, and the ms of them the caller waited for a batch."""
            nonlocal state
            out, waits = [], []
            for i in range(INPUT_TIMED_STEPS + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                batch = next_batch()
                t1 = time.perf_counter()
                state, _ = step_fn(state, batch, gen)
                torch.cuda.synchronize()
                if i:
                    out.append((time.perf_counter() - t0) * 1e3)
                    waits.append((t1 - t0) * 1e3)
            return out, waits

        shard_ms, shard_wait = step_times(lambda: next(it))
        synth_ms, _ = step_times(lambda: synth)
        shard_trace = trace(lambda: step_fn(state, next(it), gen), n=3,
                            unit="step")
        synth_trace = trace(lambda: step_fn(state, synth, gen), n=3,
                            unit="step")
        emit(phase="input: X3D-M step, shards vs synthetic",
             clips=32, shard_step_ms=shard_ms, synthetic_step_ms=synth_ms,
             shard_wait_ms=shard_wait,
             shard_median_ms=statistics.median(shard_ms),
             synthetic_median_ms=statistics.median(synth_ms),
             shard_idle_share=shard_trace["idle_share"],
             synthetic_idle_share=synth_trace["idle_share"],
             shard_family_ms=shard_trace["family_ms_per_step"],
             shard_busy_ms=shard_trace["device_busy_ms_per_step"],
             synthetic_busy_ms=synth_trace["device_busy_ms_per_step"],
             loader_threads=reader.threads)
        it.close()
        # the same with fewer loader threads: the loader's threads share
        # the host's cores (and the interpreter) with the launch loop
        sweep = {}
        for threads in (4, 2):
            it = InputReader(cfg_m, True, seed=SEED,
                             num_threads=threads)(pattern, 32)
            step_fn(state, next(it), gen)
            ms, wait = step_times(lambda: next(it))
            it.close()
            sweep[threads] = {"median_ms": statistics.median(ms),
                              "wait_median_ms": statistics.median(wait)}
        sweep[reader.threads] = {
            "median_ms": statistics.median(shard_ms),
            "wait_median_ms": statistics.median(shard_wait)}
        sweep["synthetic"] = {"median_ms": statistics.median(
            step_times(lambda: synth)[0])}
        # the synthetic step with the loader's host work beside it: each
        # step the loader's threads plan one batch of records (inflate,
        # CRC, walk, sampling, crop), and nothing is decoded; near the
        # shard-fed step, the host work is what slows that step
        planner = InputReader(cfg_m, True, seed=SEED + 1)
        plans = planner.plan_batches(pattern, 32)
        next(plans)                                  # fills the reservoir
        ms, wait = step_times(lambda: (next(plans), synth)[1])
        planned = trace(lambda: (next(plans), step_fn(state, synth, gen)),
                        n=3, unit="step")
        plans.close()
        sweep["synthetic, a batch planned beside each step"] = {
            "median_ms": statistics.median(ms),
            "wait_median_ms": statistics.median(wait),
            "idle_share": planned["idle_share"]}
        emit(phase="input: X3D-M step from shards by loader threads",
             clips=32, host_cores=os.cpu_count(), steps=INPUT_TIMED_STEPS,
             rows=sweep)

        # --------------- device time of a batch: decode and clip kernel
        decode_rows = []
        for v, training, batch in (("M", True, 32), ("XS", True, 128),
                                   ("M", False, 4)):
            cfg = config(v)
            r = InputReader(cfg, training, seed=SEED)
            chunks = r.plan_batches(pattern, batch)
            plans = next(chunks)
            chunks.close()
            s = trace(lambda: r.batch(plans), n=3, unit="batch",
                      group=lambda n: "clip" if "clip_prep_kernel" in n
                      else family(n))
            g = s["group_ms_per_batch"]
            decode_rows.append({
                "variant": v, "training": training, "videos": batch,
                "decoded_frames": sum(len(p.blobs) for p in plans),
                "busy_ms": s["device_busy_ms_per_batch"],
                "clip_ms": g.get("clip", 0.0),
                "decode_ms": s["device_busy_ms_per_batch"] - g.get("clip", 0),
                "groups_ms": g, "top_kernels": s["top_kernels_ms_per_batch"],
                "batch_wall_ms": statistics.median(
                    _wall_ms(lambda: r.batch(plans)) for _ in range(3))})
            emit(phase="input: device time a batch", **decode_rows[-1])
            if v == "M" and training:
                # the same decode on nvJPEG's default backend (Huffman on
                # the host), against the backend the port chose
                blobs = [b for p in plans for b in p.blobs]
                hw = [(p.height, p.width) for p in plans for _ in p.blobs]
                alt = jpeg.Codec(dev, backends=("default",))
                a, _ = jpeg.decode_batch(blobs, hw, dev)
                b, _ = jpeg.decode_batch(blobs, hw, dev, codec=alt)
                emit(phase="input: nvJPEG backends, X3D-M batch",
                     frames=len(blobs), chosen=jpeg.device_codec(dev).backend,
                     chosen_wall_ms=statistics.median(_wall_ms(
                         lambda: jpeg.decode_batch(blobs, hw, dev))
                         for _ in range(3)),
                     default_wall_ms=statistics.median(_wall_ms(
                         lambda: jpeg.decode_batch(blobs, hw, dev,
                                                   codec=alt))
                         for _ in range(3)),
                     same_pixels=bool(torch.equal(a, b)),
                     max_abs_diff=int((a.int() - b.int()).abs().max()))
                alt.close()
                del a, b, alt

        # --------------------------------------------- the loader alone
        # (its own reservoir, 16 batches of records: the first batch fills
        # it and is timed apart as set-up)
        cores = os.cpu_count()
        rates = {v: bench_loader.loader_rate(
            variant_config(v), pattern, batch, n, None, dev)
            for v, batch, n in (("M", 32, 6), ("XS", 128, 3))}
        rates["M, one thread"] = bench_loader.loader_rate(
            variant_config("M"), pattern, 32, 2, 1, dev)
        split = bench_loader.thread_split(variant_config("M"), pattern, dev)
        emit(phase="input: loader alone", host_cores=cores, rates=rates,
             threads=min(8, cores), thread_ms_per_record=split)

        # ----------------------------------------- the X3D-S tools on shards
        s_config = "x3d_tpu_torch/configs/kinetics/X3D_S.yaml"
        with tempfile.TemporaryDirectory() as run_dir:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc_train = train_cli.main(
                    [f"--config={s_config}", f"--model_dir={run_dir}",
                     "--use_tfrecord", f"--train_file_pattern={pattern}",
                     f"--val_file_pattern={pattern}", "--steps_per_epoch=3",
                     "--epochs=2"])
                rc_eval = eval_cli.main(
                    [f"--cfg={s_config}", f"--model_folder={run_dir}",
                     "--tfrecord", f"--test_file_pattern={pattern}",
                     "--max_batches=2"])
                rc_pred = predict_cli.main(
                    [f"--cfg={s_config}", f"--model_folder={run_dir}",
                     f"--file_pattern={pattern}", "--max_batches=1",
                     "--batch_videos=2"])
            rows = [json.loads(ln) for ln in out.getvalue().splitlines()
                    if ln.startswith("{")]
        preds = [r for r in rows if "top" in r]
        evals = [r for r in rows if "acc" in r]
        emit(phase="input: X3D-S tools on shards",
             rc=[rc_train, rc_eval, rc_pred], eval=evals, predictions=preds)
        check(rc_train == rc_eval == rc_pred == 0 and len(evals) == 1
              and evals[0]["count"] == 16.0 and len(preds) == 2
              and [p["label"] for p in preds] == labels[:2],
              f"X3D-S tools on shards: {rc_train} {rc_eval} {rc_pred} "
              f"{evals} {preds}")

        m = cases[0]
        return {"name": "clip_prep", "route": "cuda",
                "source": "x3d_tpu_torch/kernels/csrc/clip_prep.cu",
                "replaces": CLIP_REPLACES,
                "launches": launches["clip_prep"],
                "path": f"X3D-M training from shards, {TRAIN_STEPS} steps",
                "max_abs_err": worst_err, "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                "bound_by": m["bound_by"], "library_ms": None,
                "cases": cases, "decode": decode_rows,
                "nvjpeg_decode_launches": launches["nvjpeg_decode"]}
    finally:
        if work is not None:
            work.cleanup()


def kernel_counters() -> dict:
    """{name: wrapper} of K1-K9: each wrapper adds one to its ``launches``
    where it launches its kernel (and, with more than one body, to its
    ``body_launches`` under the body)."""
    from x3d_tpu_torch.ops import depthwise, dw_fused, pointwise, pw_stats
    from x3d_tpu_torch.tools import fma_probe

    return {"K1": depthwise.depthwise_conv3d,
            "K2": dw_fused.dw_bn_act_conv,
            "K3": dw_fused.dw_bn_act_conv_bwd,
            "K4 dx": depthwise.depthwise_conv3d_dx,
            "K4 dk": depthwise.depthwise_conv3d_dk,
            "K5": pw_stats.pw_conv_stats,
            "K6": pw_stats.pw_act_conv_stats,
            "K7": pointwise.pw_conv,
            "K8": depthwise.depthwise_conv3d_pbwd,
            "K9": fma_probe.fma_chain}


def zero_counts() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0
        for key in ("body_launches", "epilogue_launches"):
            counts = getattr(fn, key, None)
            if counts is not None:
                counts.update(dict.fromkeys(counts, 0))


def read_counts() -> dict:
    return {k: fn.launches for k, fn in kernel_counters().items()}


def read_epilogues() -> dict:
    """Launches with a BN epilogue by kind, of K1, K2 and K7."""
    return {k: dict(fn.epilogue_launches)
            for k, fn in kernel_counters().items()
            if hasattr(fn, "epilogue_launches")}


def read_bodies() -> dict:
    """Launches by body of the kernels that have more than one."""
    return {k: dict(fn.body_launches) for k, fn in kernel_counters().items()
            if hasattr(fn, "body_launches")}


def k7_want(vcfg, varch, train, times, remat=False, clips=CLIPS, elem=2):
    """K7's launches by body over ``times`` forwards (training steps:
    forward and dx, and with ``remat`` the blocks' forward calls once
    more) of X3D-``vcfg`` on ``clips`` clips of ``elem``-byte elements,
    each call by the body its plan names (``pointwise.pw_body``)."""
    from x3d_tpu_torch.ops import pointwise
    from x3d_tpu_torch.tools import profile_pointwise

    crop = vcfg.DATA.TRAIN_CROP_SIZE if train \
        else vcfg.DATA.TEST_CROP_SIZE
    found = profile_pointwise.cases(vcfg, varch, clips, crop, train)
    calls = profile_pointwise.with_dx(found) if train else found
    if remat:
        calls = calls + found[:-1]         # all but conv_5, in the head
    want = dict.fromkeys(pointwise.pw_conv.body_launches, 0)
    for _, shape, N, strides, n in calls:
        M = shape[0] * shape[1] * -(-shape[2] // strides[1]) \
            * -(-shape[3] // strides[2])
        want[pointwise.pw_body(shape[-1], N, M, strides, elem=elem,
                               width=shape[3], height=shape[2])] += n * times
    return want


def recomputes_convs(remat) -> bool:
    """Whether a remat mode runs the blocks' conv kernels again in the
    backward pass: "block" and "stage" do, "convs" keeps their outputs."""
    return remat in ("block", "stage")


def want_step_of(varch, stem_k8, remat):
    """Launches per training step by kernel: the stem's backward by K8,
    or by K4 dx and dk where K8 cannot take it (X3D-XS); with remat
    "block" or "stage" every kernel of a block's forward runs once more in
    the backward pass (the stem and the head are outside every region),
    with "convs" none does."""
    ns = len(varch.stages)
    n2 = sum(len(b) - 1 for b in varch.stages)
    again = 1 + recomputes_convs(remat)
    k4 = ns + (not stem_k8)
    return {"K1": 1 + ns * again, "K2": n2 * again, "K3": n2,
            "K4 dx": k4, "K4 dk": k4, "K5": n2 * again, "K6": n2 * again,
            "K7": 2 * (3 * ns + 1) + (again - 1) * 3 * ns,
            "K8": int(stem_k8), "K9": 0}

def bodies_of_steps(vcfg, varch, want, steps, stem_k8, remat):
    """The bodies ``steps`` training steps launch: K1 the temporal body
    at the stem and the ring body at the stage entries; K2, K3 and K4
    dk's stage entries the ring bodies, K4 dx's the phase body; the
    XS stem's backward K4's gather and generic bodies; K8 the temporal
    body; K7 as its plan names."""
    ns, xs = len(varch.stages), int(not stem_k8)
    return {"K1": {"temporal": steps, "ring": steps * (want["K1"] - 1),
                   "generic": 0},
            "K2": {"ring": steps * want["K2"], "generic": 0},
            "K3": {"ring": steps * want["K3"], "generic": 0},
            "K4 dx": {"phase": steps * ns, "gather": steps * xs},
            "K4 dk": {"ring": steps * ns, "generic": steps * xs},
            "K7": k7_want(vcfg, varch, True, steps, recomputes_convs(remat)),
            "K8": {"temporal": steps * want["K8"], "generic": 0}}


def snapshot(state):
    """Copies of a train state's model, optimizer and step."""
    return (copy.deepcopy(state.model.state_dict()),
            copy.deepcopy(state.optimizer.state_dict()), state.step)

def restore(state, snap):
    """Put ``state`` back to a :func:`snapshot`."""
    state.model.load_state_dict(snap[0])
    # the optimizer adopts the tensors it is given (momentum buffers are
    # updated in place), so it gets a copy of the snapshot's
    state.optimizer.load_state_dict(copy.deepcopy(snap[1]))
    state.step = snap[2]


def grad_diff(got, want):
    """(relative L2 over all leaves, worst leaf's relative L2, least leaf
    cosine) of two gradient dicts."""
    import torch.nn.functional as F

    num = den = 0.0
    worst, cos = 0.0, 1.0
    for n, w in want.items():
        g = got[n].double().flatten()
        w = w.double().flatten()
        num += (g - w).square().sum().item()
        den += w.square().sum().item()
        worst = max(worst, ((g - w).norm()
                            / w.norm().clamp_min(1e-30)).item())
        cos = min(cos, F.cosine_similarity(g, w, dim=0).item())
    return (num / max(den, 1e-300)) ** 0.5, worst, cos


def update_diff(got, want, before, names):
    """(relative L2 over all leaves, worst leaf's) of the updated
    parameters ``names`` against another step's update from ``before``,
    after two float32 ulps of each parameter's norm."""
    num = den = 0.0
    worst = 0.0
    for n in names:
        w = want[n].double()
        u = (w - before[n].double()).norm().item()
        d = max((got[n].double() - w).norm().item()
                - 2.4e-7 * w.norm().item(), 0.0)
        num, den = num + d * d, den + u * u
        worst = max(worst, d / max(u, 1e-30))
    return (num / max(den, 1e-300)) ** 0.5, worst


def stats_err(got, want):
    """The running statistics' largest difference over their leaf's
    largest value."""
    return max((got[n] - v).abs().max().item() / v.abs().max().item()
               for n, v in want.items() if n.endswith((".mean", ".var")))


def f32_step_check(emit, check, vcfg, variant, want, calibrate=False,
                   clips=PARITY_CLIPS, label=None, bn_groups=1):
    """One float32 step at ``clips`` clips (PARITY_CLIPS unless given)
    through the kernels
    against the same step through the plain versions, from one state
    and batch: the loss, every gradient, the updated parameters and the
    BN running statistics; ``want``: the kernels' launches.  With
    ``calibrate`` (the deeper variants) the plain step also runs on the
    batch nudged by 1e-6 of each input value, and the gradient and
    update bounds become what that nudge moves the plain step by where
    it moves it by more than TOL_STEP_*: the step's own sensitivity.
    ``label`` names the check in its row and failures (default: the
    variant); ``bn_groups`` > 1 takes per-replica BN statistics over that
    many groups of the batch."""
    import torch

    from x3d_tpu_torch.data import synthetic_batches
    from x3d_tpu_torch.models import create_model
    from x3d_tpu_torch.ops import plain_versions
    from x3d_tpu_torch.train import create_train_state, make_train_step

    dropout_gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = create_model(vcfg, dtype=torch.float32, seed=SEED + 1,
                         bn_groups=bn_groups)
    state = create_train_state(vcfg, model)
    train_step = make_train_step(model, vcfg.NETWORK.WEIGHT_DECAY)
    batch = next(synthetic_batches(vcfg, clips,
                                   dtype=torch.float32, seed=SEED + 1))
    runs = [(False, batch), (True, batch)]
    if calibrate:
        nudge = torch.Generator(device="cuda").manual_seed(SEED + 2)
        runs.append((True, {**batch, "video": batch["video"] * (
            1 + 1e-6 * torch.randn(batch["video"].shape, generator=nudge,
                                   device="cuda"))}))
    snap = snapshot(state)
    results = []
    for plain, data in runs:
        restore(state, snap)
        zero_counts()
        if plain:
            with plain_versions():
                state, metrics = train_step(state, data, dropout_gen)
        else:
            state, metrics = train_step(state, data, dropout_gen)
        torch.cuda.synchronize()
        results.append((float(metrics["loss"]),
                        {n: p.grad.clone()
                         for n, p in model.named_parameters()},
                        copy.deepcopy(model.state_dict()), read_counts()))

    (loss_k, grads_k, after_k, n_k), (loss_p, grads_p, after_p, n_p) = \
        results[:2]
    g_l2, g_leaf, g_cos = grad_diff(grads_k, grads_p)
    u_l2, u_leaf = update_diff(after_k, after_p, snap[0], grads_p)
    tol_l2, tol_leaf, tol_cos = TOL_STEP_L2, TOL_STEP_LEAF_L2, TOL_STEP_COS
    sensitivity = {}
    if calibrate:
        n_l2, n_leaf, n_cos = grad_diff(results[2][1], grads_p)
        nu_l2, nu_leaf = update_diff(results[2][2], after_p, snap[0],
                                     grads_p)
        sensitivity = dict(nudged_grad_rel_l2=n_l2,
                           nudged_grad_worst_leaf_rel_l2=n_leaf,
                           nudged_grad_least_leaf_cosine=n_cos,
                           nudged_update_rel_l2=nu_l2,
                           nudged_update_worst_leaf_rel_l2=nu_leaf)
        tol_l2 = max(tol_l2, n_l2, nu_l2)
        tol_leaf = max(tol_leaf, n_leaf, nu_leaf)
        tol_cos = min(tol_cos, n_cos)
    s_err = stats_err(after_k, after_p)
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    where = label if label is not None \
        else "" if variant == "M" else f"X3D-{variant} "
    emit(phase=f"{where}train f32 kernels vs plain", clips=clips,
         remat=model.remat, loss_kernels=loss_k, loss_plain=loss_p,
         loss_rel_err=loss_err, grad_rel_l2=g_l2,
         grad_worst_leaf_rel_l2=g_leaf, grad_least_leaf_cosine=g_cos,
         update_rel_l2=u_l2, update_worst_leaf_rel_l2=u_leaf,
         stats_err_of_leaf_max=s_err, bn_groups=bn_groups, **sensitivity,
         kernel_launches=n_k, plain_launches=n_p)
    check(loss_err <= TOL_STEP_LOSS,
          f"{where}f32 step loss err {loss_err}")
    check(g_l2 <= tol_l2 and g_leaf <= tol_leaf and g_cos >= tol_cos,
          f"{where}f32 step grads: rel L2 {g_l2}, worst leaf {g_leaf}, "
          f"least cosine {g_cos}; {sensitivity}")
    check(u_l2 <= tol_l2 and u_leaf <= tol_leaf,
          f"{where}f32 step update: rel L2 {u_l2}, worst leaf {u_leaf}")
    check(s_err <= TOL_STEP_STATS,
          f"{where}f32 step stats err {s_err}")
    check(n_k == want and set(n_p.values()) == {0},
          f"{where}f32 step launches kernels {n_k} plain {n_p}")
    del model, state, results
    torch.cuda.empty_cache()


def multigrid_phase(emit, check, pattern) -> dict:
    """Phase 11c: long-cycle multigrid training.  X3D-M at full width and
    depth through ``tools/train --multigrid --synthetic`` (default factors,
    MG_EPOCHS epochs of MG_BASE_STEPS base steps): every step's batch at its
    phase's shape, every loss finite, each epoch's launches by body; a
    crash after the checkpoint inside phase 1 and the same command resuming
    to the uninterrupted run's final state, bit for bit.  Per phase, bare
    steps on one model: step median, clips/s, peak memory, the device's
    idle share, and the stem backward's route and time; a float32 step
    through the kernels against the plain versions at each phase's full
    batch, and at phase 0's shape at PARITY_CLIPS clips with the nudge's
    sensitivity.  X3D-XS's phases 0 and 1 (1 and 2 frames, fewer than the
    temporal taps): K2 and K3 against their plain versions at each
    segment and the float32 step, at the full phase batch.  One bfloat16
    step at each phase shape of X3D-S and X3D-XS.
    The tool on the shards at ``pattern`` with validation and 2 batches of
    precise BN.  ``bench_multigrid --variant=M``.  Returns the tool run's
    launches and bodies by phase for the ``kernels`` line."""
    import statistics

    import torch

    import x3d_tpu_torch.data as data_mod
    import x3d_tpu_torch.train.multigrid as mg
    from x3d_tpu_torch import variant_config
    from x3d_tpu_torch.data import synthetic_batches
    from x3d_tpu_torch.models import build_arch, create_model
    from x3d_tpu_torch.ops import depthwise, dw_fused
    from x3d_tpu_torch.ops.timing import time_fn
    from x3d_tpu_torch.tools import bench_multigrid
    from x3d_tpu_torch.tools import train as train_cli
    from x3d_tpu_torch.tools.trace import trace
    from x3d_tpu_torch.train import create_train_state, make_train_step

    m_config = "x3d_tpu_torch/configs/kinetics/X3D_M.yaml"
    cfg = variant_config("M")
    arch = build_arch(cfg)
    sched = mg.MultigridSchedule(cfg, MG_BASE_STEPS, MG_EPOCHS)
    kt = arch.temp_filter
    stem_pads = ((kt // 2,) * 2, (0, 0), (0, 0))

    def stem_shape(c, B):
        S = c.DATA.TRAIN_CROP_SIZE // 2
        return (B, c.DATA.TEMP_DURATION, S, S, arch.conv1_dim)

    def stem_k8(c, B):
        return depthwise.pbwd_eligible(stem_shape(c, B), (kt, 1, 1),
                                       (1, 1, 1), stem_pads)

    class Crash(Exception):
        pass

    class Walk:
        """Each step's loss and LR, each epoch's launches and bodies; raises
        Crash after step ``crash_at`` (after the checkpoint hook)."""

        def __init__(self, crash_at=None):
            self.state, self.losses, self.lrs, self.epochs = None, {}, {}, []
            self.crash_at = crash_at

        def on_epoch_start(self, epoch, lr):
            self.epochs.append({"epoch": epoch, "lr": lr,
                                "counts": read_counts(),
                                "bodies": read_bodies()})

        def on_step(self, step, metrics):
            self.losses[step] = metrics["loss"]

        def on_step_end(self, step, state):
            self.state = state
            self.lrs[step] = state.optimizer.param_groups[0]["lr"]
            if step == self.crash_at:
                raise Crash(step)

        def on_epoch_end(self, epoch, state, train_metrics, val_metrics):
            e = self.epochs[-1]
            c, b = read_counts(), read_bodies()
            start = e.pop("counts")
            e["launches"] = {k: c[k] - start[k] for k in c}
            e["bodies"] = {k: {n: b[k][n] - e["bodies"][k][n] for n in b[k]}
                           for k in b}
            e["val"] = val_metrics

        def on_train_end(self): ...

    shapes = []
    real_batches = data_mod.synthetic_batches

    def recording(*args, **kw):
        for batch in real_batches(*args, **kw):
            shapes.append(list(batch["video"].shape))
            yield batch

    def run_tool(model_dir, walk, *extra):
        argv = [f"--config={m_config}", "--multigrid",
                f"--model_dir={model_dir}",
                f"--steps_per_epoch={MG_BASE_STEPS}",
                f"--epochs={MG_EPOCHS}", "--save_checkpoints_step=1", *extra]
        try:
            rc = train_cli.main(argv, extra_hooks=[walk])
        except Crash:
            rc = "crashed"
        torch.cuda.synchronize()
        return rc

    out = {"launches": {}, "bodies": {}}
    data_mod.synthetic_batches = recording
    try:
        with tempfile.TemporaryDirectory() as run_dir, \
                tempfile.TemporaryDirectory() as crash_dir:
            # ------------------------- the tool, uninterrupted (counted)
            torch.cuda.reset_peak_memory_stats()
            zero_counts()                   # the multigrid path starts here
            t0 = time.perf_counter()
            walk = Walk()
            rc = run_tool(run_dir, walk, "--synthetic")
            wall_s = time.perf_counter() - t0
            launches = read_counts()        # ... and ends here
            peak = torch.cuda.max_memory_allocated()
            want_shapes = [[p.batch_size, p.temp_duration, p.crop_size,
                            p.crop_size, 3]
                           for e in range(MG_EPOCHS)
                           for p in [sched.phase_for_epoch(e)]
                           for _ in range(p.steps_per_epoch)]
            total = sched.total_steps()
            emit(phase="multigrid: X3D-M train tool", schedule=sched.describe(),
                 epoch_phase=sched.epoch_phase,
                 first_step=sched.first_step.tolist(), rc=rc, seconds=wall_s,
                 losses=walk.losses, lrs=walk.lrs, batch_shapes=shapes,
                 launches=launches, peak_memory_bytes=peak)
            check(rc == 0 and walk.state is not None
                  and walk.state.step == total == 23,
                  f"multigrid tool: rc {rc}, steps {total}")
            check(shapes == want_shapes,
                  f"multigrid batch shapes {shapes}, want {want_shapes}")
            check(sorted(walk.losses) == list(range(1, total + 1))
                  and all(math.isfinite(v) for v in walk.losses.values()),
                  f"multigrid losses {walk.losses}")
            lr_fn = sched.make_lr_schedule()
            check(walk.lrs == {s + 1: lr_fn(s) for s in range(total)},
                  f"multigrid LRs {walk.lrs}")
            for e in walk.epochs:
                p = sched.phase_for_epoch(e["epoch"])
                pc = p.apply_to_config(cfg)
                k8 = stem_k8(pc, p.batch_size)
                want = want_step_of(arch, k8, "off")
                n = p.steps_per_epoch
                want_launches = {k: n * v for k, v in want.items()}
                want_bodies = bodies_of_steps(pc, arch, want, n, k8, "off")
                check(e["launches"] == want_launches,
                      f"multigrid epoch {e['epoch']} launches "
                      f"{e['launches']}, want {want_launches}")
                for kname, w in want_bodies.items():
                    check(e["bodies"][kname] == w,
                          f"multigrid epoch {e['epoch']} {kname} bodies "
                          f"{e['bodies'][kname]}, want {w}")
                key = f"phase {p.index}"
                got_l = out["launches"].setdefault(key, dict.fromkeys(
                    e["launches"], 0))
                for k, v in e["launches"].items():
                    got_l[k] += v
                got_b = out["bodies"].setdefault(key, {
                    k: dict.fromkeys(v, 0) for k, v in e["bodies"].items()})
                for k, v in e["bodies"].items():
                    for body, m in v.items():
                        got_b[k][body] += m
            emit(phase="multigrid: X3D-M launches by phase",
                 launches=out["launches"], bodies=out["bodies"])
            final = (copy.deepcopy(walk.state.model.state_dict()),
                     copy.deepcopy(walk.state.optimizer.state_dict()))
            del walk

            # ---------- crash after the step-2 checkpoint (phase 1), resume
            crash_at = int(sched.first_step[1]) + 1
            first = Walk(crash_at=crash_at)
            rc_crash = run_tool(crash_dir, first, "--synthetic")
            lines = []

            class Lines(logging.Handler):
                def emit(self, record):
                    lines.append(record.getMessage())

            handler = Lines()
            logging.getLogger("x3d_tpu_torch").addHandler(handler)
            try:
                second = Walk()
                rc_resume = run_tool(crash_dir, second, "--synthetic")
            finally:
                logging.getLogger("x3d_tpu_torch").removeHandler(handler)
            named = [ln for ln in lines if ln.startswith("resumed at")]
            model_sd = second.state.model.state_dict()
            opt_sd = second.state.optimizer.state_dict()
            same = (all(torch.equal(model_sd[k], v)
                        for k, v in final[0].items())
                    and opt_sd["param_groups"] == final[1]["param_groups"]
                    and all(torch.equal(opt_sd["state"][i][n], v)
                            for i, slots in final[1]["state"].items()
                            for n, v in slots.items()))
            epoch, in_epoch = sched.position_for_step(crash_at)
            emit(phase="multigrid: X3D-M crash and resume", crash_at=crash_at,
                 rc=[rc_crash, rc_resume], log=named,
                 resumed_steps=sorted(second.lrs), bit_identical=same)
            check(rc_crash == "crashed" and rc_resume == 0
                  and named == [f"resumed at global step {crash_at} (epoch "
                                f"{epoch}, step-in-epoch {in_epoch})"]
                  and sorted(second.lrs) == list(range(crash_at + 1,
                                                       total + 1)),
                  f"multigrid resume: {rc_crash} {rc_resume} {named}")
            check(same, "the resumed multigrid run differs from the "
                        "uninterrupted one")
            del first, second, final, model_sd, opt_sd
    finally:
        data_mod.synthetic_batches = real_batches
    torch.cuda.empty_cache()

    # ----------------------- per phase: bare steps, trace, the stem's route
    def time_ms(fn):
        return time_fn(fn, iters=10) * 1e3

    model = create_model(cfg, seed=SEED)
    state = create_train_state(cfg, model)
    step_fn = make_train_step(model, cfg.NETWORK.WEIGHT_DECAY)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for p in sched.phases:
        pc = p.apply_to_config(cfg)
        B = p.batch_size
        batch = next(synthetic_batches(pc, B, seed=SEED))
        step_fn(state, batch, gen)                       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(MG_TIMED_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step_fn(state, batch, gen)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated()
        summary = trace(lambda: step_fn(state, batch, gen), n=2, unit="step",
                        warmup=0)
        shape = stem_shape(pc, B)
        kd, one = (kt, 1, 1), (1, 1, 1)
        u = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        gy = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        k = (0.3 * torch.randn((*kd, 1, shape[-1]), generator=gen,
                               device="cuda")).bfloat16()
        if stem_k8(pc, B):
            route = f"K8 {depthwise.pbwd_body(kd, stem_pads)}"
            stem = {"K8": time_ms(
                lambda: depthwise.depthwise_conv3d_pbwd(u, gy, k))}
        else:
            route = (f"K4 dx {depthwise.dx_body(kd, one, stem_pads)} + dk "
                     f"{depthwise.dk_body(kd, one, stem_pads)}")
            stem = {"K4 dx": time_ms(lambda: depthwise.depthwise_conv3d_dx(
                        gy, k, shape, one, stem_pads)),
                    "K4 dk": time_ms(lambda: depthwise.depthwise_conv3d_dk(
                        u, gy, kd, one, stem_pads))}
        median = statistics.median(times)
        row = {"phase_index": p.index, "clips": B,
               "input": f"{p.temp_duration}x{p.crop_size}^2",
               "step_ms": times, "step_ms_median": median,
               "clips_per_s": B / median * 1e3,
               "peak_memory_bytes": peak,
               "idle_share": summary["idle_share"],
               "device_busy_ms_per_step": summary["device_busy_ms_per_step"],
               "family_ms_per_step": summary["family_ms_per_step"],
               "stem_shape": list(shape), "stem_backward_route": route,
               "stem_backward_ms": stem,
               "stem_backward_total_ms": sum(stem.values())}
        rows.append(row)
        emit(phase="multigrid: X3D-M phase step", **row)
        del batch, u, gy, k
        torch.cuda.empty_cache()
    out["rows"] = rows
    del model, state, step_fn
    torch.cuda.empty_cache()

    # ------------ float32 steps at each phase's full batch, kernels vs plain
    for p in sched.phases:
        pc = p.apply_to_config(cfg)
        f32_step_check(
            emit, check, pc, "M",
            want_step_of(arch, stem_k8(pc, p.batch_size), "off"),
            clips=p.batch_size,
            label=f"multigrid X3D-M phase {p.index} ({p.batch_size} x "
                  f"{p.temp_duration}x{p.crop_size}^2) ")

    # The float32 step at phase 0's shape at PARITY_CLIPS clips, as phase 6
    # takes it at the base shape, with the nudge's sensitivity beside it: at
    # 4 clips of 4x160^2 the step is far worse conditioned than at the full
    # batch (fewer values a BN channel, fewer clips a head unit).
    p0 = sched.phases[0].apply_to_config(cfg)
    f32_step_check(
        emit, check, p0, "M", want_step_of(arch, stem_k8(p0, PARITY_CLIPS),
                                           "off"),
        calibrate=True, label=f"multigrid X3D-M phase 0 at {PARITY_CLIPS} "
                              f"clips ")

    # ---- X3D-XS's phases 0 and 1: 1 and 2 frames, under the stem's 5 taps
    # and the fused segments' 3.  K2 and K3 against their plain versions at
    # each stage's segment at the phase's full batch (phase 11's
    # tolerances), then the float32 step at the full batch.
    xs_cfg = variant_config("XS")
    xs_arch = build_arch(xs_cfg)
    seg_gen = torch.Generator(device="cuda").manual_seed(SEED + 3)

    def randn(*shape):
        return torch.randn(shape, generator=seg_gen, device="cuda")

    def rel_err(got, ref, scale):
        return ((got.float() - ref.float()).abs()
                / scale.float().clamp_min(1e-30)).max().item()

    for p in mg.MultigridSchedule(xs_cfg, MG_BASE_STEPS,
                                  MG_EPOCHS).phases[:2]:
        pc = p.apply_to_config(xs_cfg)
        B, T = p.batch_size, p.temp_duration
        S = p.crop_size // 2
        kdims = (xs_arch.temp_kernel, 3, 3)
        for si, blocks in enumerate(xs_arch.stages):
            S = -(-S // 2)
            C = blocks[0].inner_channels
            where = (f"X3D-XS multigrid phase {p.index} stage{si + 2} "
                     f"segment ({B} x {T}x{S}^2 x {C})")
            for dtype in (torch.float32, torch.bfloat16):
                x = randn(B, T, S, S, C).to(dtype)
                a = 0.5 + torch.rand((C, B), generator=seg_gen, device="cuda")
                b = 0.3 * randn(C, B)
                k = (0.3 * randn(*kdims, 1, C)).to(dtype)
                zero_counts()
                y, ps, s2 = dw_fused.dw_bn_act_conv(x, a, b, k)
                gy = randn(B, T, S, S, C).to(dtype)
                gp, gs2 = 0.1 * randn(C, B), 0.05 * randn(C, B)
                got = dw_fused.dw_bn_act_conv_bwd(x, a, b, k, y, gy, gp, gs2)
                torch.cuda.synchronize()
                bodies = read_bodies()
                yr, pr, s2r = dw_fused.reference(x.float(), a, b, k.float())
                col = yr.abs().sum(dim=(1, 2, 3)).t()
                e2 = ((y.float() - yr).abs().max().item(),
                      rel_err(y, yr, yr.abs().max()),
                      max(rel_err(ps, pr, col), rel_err(s2, s2r, s2r.abs())))
                del yr, pr, s2r, col
                want = dw_fused.bwd_reference(x, a, b, k, y, gy, gp, gs2)
                scales = dw_fused.bwd_abs_sums(x, a, b, k, y, gy, gp, gs2)
                e3 = ((got[0].float() - want[0].float()).abs().max().item(),
                      rel_err(got[0], want[0], want[0].float().abs().max()),
                      max(rel_err(g_, w_, s_) for g_, w_, s_ in
                          zip(got[1:], want[1:], scales)))
                emit(phase="multigrid: X3D-XS K2 and K3 vs plain",
                     phase_index=p.index, stage=si + 2, shape=[B, T, S, S, C],
                     dtype=str(dtype), k2_max_abs_err=e2[0],
                     k2_rel_err=e2[1], k2_sums_err=e2[2],
                     k3_max_abs_err=e3[0], k3_rel_err=e3[1],
                     k3_sums_err=e3[2], k2_bodies=bodies["K2"],
                     k3_bodies=bodies["K3"])
                check(bodies["K2"] == {"ring": 1, "generic": 0}
                      and bodies["K3"] == {"ring": 1, "generic": 0},
                      f"{where}: K2/K3 bodies {bodies}")
                if dtype == torch.float32:
                    check(e2[0] <= TOL_F32 and e2[2] <= TOL_F32_SUMS,
                          f"K2 {where} f32 err {e2}")
                    check(e3[0] <= TOL_F32 and e3[2] <= TOL_TRAIN_SUMS,
                          f"K3 {where} f32 err {e3}")
                else:
                    check(max(e2[1], e2[2]) <= TOL_BF16,
                          f"K2 {where} bf16 err {e2}")
                    check(e3[1] <= TOL_BF16 and e3[2] <= TOL_TRAIN_SUMS,
                          f"K3 {where} bf16 err {e3}")
                del x, a, b, k, y, ps, s2, gy, gp, gs2, got, want, scales
                torch.cuda.empty_cache()
        stem = (B, T, p.crop_size // 2, p.crop_size // 2,
                xs_arch.conv1_dim)
        f32_step_check(
            emit, check, pc, "XS",
            want_step_of(xs_arch, depthwise.pbwd_eligible(
                stem, (xs_arch.temp_filter, 1, 1), (1, 1, 1),
                ((xs_arch.temp_filter // 2,) * 2, (0, 0), (0, 0))), "off"),
            calibrate=True, clips=B,
            label=f"multigrid X3D-XS phase {p.index} ({B} x "
                  f"{T}x{p.crop_size}^2) ")

    # ------------- X3D-S and X3D-XS: one bfloat16 step at each phase shape
    for v in ("S", "XS"):
        vcfg = variant_config(v)
        varch = build_arch(vcfg)
        model = create_model(vcfg, seed=SEED)
        state = create_train_state(vcfg, model)
        step_fn = make_train_step(model, vcfg.NETWORK.WEIGHT_DECAY)
        for p in mg.MultigridSchedule(vcfg, MG_BASE_STEPS, MG_EPOCHS).phases:
            pc = p.apply_to_config(vcfg)
            B = p.batch_size
            batch = next(synthetic_batches(pc, B, seed=SEED))
            S = pc.DATA.TRAIN_CROP_SIZE // 2
            k8 = depthwise.pbwd_eligible(
                (B, p.temp_duration, S, S, varch.conv1_dim),
                (varch.temp_filter, 1, 1), (1, 1, 1),
                ((varch.temp_filter // 2,) * 2, (0, 0), (0, 0)))
            want = want_step_of(varch, k8, "off")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, metrics = step_fn(state, batch, gen)
            end.record()
            end.synchronize()
            got, bodies = read_counts(), read_bodies()
            loss = float(metrics["loss"])
            emit(phase=f"multigrid: X3D-{v} phase step", variant=v,
                 phase_index=p.index, clips=B,
                 input=f"{p.temp_duration}x{p.crop_size}^2", loss=loss,
                 first_step_ms=start.elapsed_time(end),
                 peak_memory_bytes=torch.cuda.max_memory_allocated(),
                 launches=got, bodies=bodies)
            check(math.isfinite(loss), f"X3D-{v} multigrid phase {p.index} "
                                       f"loss {loss}")
            check(got == want, f"X3D-{v} multigrid phase {p.index} launches "
                               f"{got}, want {want}")
            for kname, w in bodies_of_steps(pc, varch, want, 1, k8,
                                            "off").items():
                check(bodies[kname] == w,
                      f"X3D-{v} multigrid phase {p.index} {kname} bodies "
                      f"{bodies[kname]}, want {w}")
            del batch
        del model, state, step_fn
        torch.cuda.empty_cache()

    # --------------------------- the tool on shards, with precise BN
    recals = []
    real_recal = mg.make_bn_recalibrator

    def recording_recal(model, batches_fn, n, seed, momentum):
        fn = real_recal(model, batches_fn, n, seed, momentum)

        def recal(state):
            def stats():
                return {k: v.clone() for k, v in model.named_buffers()}
            before = stats()
            out_state = fn(state)
            after = stats()
            recals.append((all(bool(torch.isfinite(v).all())
                               for v in after.values()),
                           sum(not torch.equal(before[k], v)
                               for k, v in after.items()), len(after)))
            return out_state

        return recal

    mg.make_bn_recalibrator = recording_recal
    try:
        with tempfile.TemporaryDirectory() as shard_run:
            walk = Walk()
            t0 = time.perf_counter()
            rc = train_cli.main(
                [f"--config={m_config}", "--multigrid", "--use_tfrecord",
                 f"--model_dir={shard_run}", f"--train_file_pattern={pattern}",
                 f"--val_file_pattern={pattern}", "--steps_per_epoch=2",
                 f"--epochs={MG_EPOCHS}", "--opts", "TRAIN.BATCH_SIZE",
                 str(MG_SHARD_BATCH), "TEST.BATCH_SIZE", "2",
                 "MULTIGRID.BN_RECALC_BATCHES", "2"], extra_hooks=[walk])
            torch.cuda.synchronize()
            shard_s = time.perf_counter() - t0
    finally:
        mg.make_bn_recalibrator = real_recal
    vals = [e["val"] for e in walk.epochs]
    emit(phase="multigrid: X3D-M train tool on shards", rc=rc,
         seconds=shard_s, base_batch=MG_SHARD_BATCH, losses=walk.losses,
         val=vals, recalibrations=[
             {"finite": f, "changed_buffers": n, "buffers": m}
             for f, n, m in recals])
    check(rc == 0 and len(vals) == MG_EPOCHS
          and all(v and v["count"] > 0 and math.isfinite(v["loss"])
                  for v in vals)
          and all(math.isfinite(v) for v in walk.losses.values()),
          f"multigrid on shards: rc {rc}, val {vals}")
    check(len(recals) == MG_EPOCHS
          and all(f and n > 0 for f, n, _ in recals),
          f"multigrid precise BN on shards: {recals}")
    del walk
    torch.cuda.empty_cache()

    # ------------------------------------------- bench_multigrid --variant=M
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench_multigrid.main(["--variant=M", f"--steps={MG_BENCH_STEPS}"])
    line = buf.getvalue().strip().splitlines()[-1]
    print(line, flush=True)
    bench = json.loads(line)
    out["bench"] = bench
    check(len(bench["phases"]) == 4
          and all(math.isfinite(p["step_ms"]) for p in bench["phases"]),
          f"bench_multigrid: {bench}")
    return out


# Import phase (phase 11d): the reference's TF checkpoint format, written
# here with numpy (no TensorFlow), imported by the port's tool.  Bundle
# layout as TensorFlow writes it: LevelDB-style table blocks of about 4 KiB
# with a restart point every 16 keys, uncompressed, each block followed by
# its compression byte and masked CRC-32C.
REF_SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"
REF_BN_LEAF = {"scale": "gamma", "bias": "beta", "mean": "moving_mean",
               "var": "moving_variance"}
BUNDLE_BLOCK_BYTES = 4096
BUNDLE_RESTART_EVERY = 16
BUNDLE_MAGIC = 0xDB4775248B80FB57


def _pb(num: int, wire: int, payload) -> bytes:
    """One proto field: a varint (wire 0) of an int, a fixed32 (wire 5) of
    an int, or a length-delimited (wire 2) payload."""
    from x3d_tpu_torch.data.tfrecords import _varint

    tag = _varint(num << 3 | wire)
    if wire == 0:
        return tag + _varint(payload & (1 << 64) - 1)
    if wire == 5:
        return tag + payload.to_bytes(4, "little")
    return tag + _varint(len(payload)) + payload


def _masked_crc32c(data: bytes) -> int:
    from x3d_tpu_torch.data.tfrecords import crc32c_python, masked_crc

    return masked_crc(crc32c_python(data))


def reference_name(path) -> str:
    """The reference's TF variable path of a Flax tree leaf ``(collection,
    module, ..., leaf)``: the inverse of the import tool's
    ``map_variable``."""
    keys = path[1:]
    top = keys[0]
    if top == "conv_1":
        name = f"conv1/bn/{REF_BN_LEAF[keys[3]]}" if keys[1] == "bn" \
            else f"conv1/{keys[1]}/{keys[2]}"
    elif top.startswith("stage"):
        stage, block = re.fullmatch(r"stage(\d+)_block(\d+)", top).groups()
        base = f"stages/{int(stage) - 2}/stage/layer_with_weights-{block}"
        rest = keys[1:]
        if rest[0] == "bn_r":
            name = f"{base}/bn_r/{REF_BN_LEAF[rest[2]]}"
        elif rest[0] == "residual":
            name = f"{base}/residual/{rest[1]}"
        elif rest[1].startswith("bn_"):
            name = f"{base}/bottleneck/{rest[1]}/{REF_BN_LEAF[rest[3]]}"
        elif rest[1] == "se":
            name = f"{base}/bottleneck/{rest[2]}/{rest[3]}"
        else:
            name = f"{base}/bottleneck/{rest[1]}/{rest[2]}"
    elif top == "conv_5":
        name = f"conv5/layer_with_weights-0/{keys[1]}"
    elif top == "bn_5":
        name = f"conv5/layer_with_weights-1/{REF_BN_LEAF[keys[2]]}"
    elif top in ("fc_1", "fc_2"):
        name = f"fc{top[-1]}/{keys[1]}"
    else:
        raise KeyError(f"no reference path for {path}")
    return name + REF_SUFFIX


def _table_block(entries, restart_every: int) -> bytes:
    """A table block of (key, value) pairs: prefix-compressed entries, the
    restart offsets, their count."""
    from x3d_tpu_torch.data.tfrecords import _varint

    out, restarts, last = bytearray(), [], b""
    for i, (key, value) in enumerate(entries):
        shared = 0
        if i % restart_every:
            while shared < min(len(key), len(last)) \
                    and key[shared] == last[shared]:
                shared += 1
        else:
            restarts.append(len(out))
        out += _varint(shared) + _varint(len(key) - shared) \
            + _varint(len(value)) + key[shared:] + value
        last = key
    for r in restarts or [0]:
        out += r.to_bytes(4, "little")
    return bytes(out + len(restarts or [0]).to_bytes(4, "little"))


def write_reference_checkpoint(prefix: str, tree, seed: int = SEED) -> dict:
    """Write a Flax tree ``{params, batch_stats}`` of numpy arrays as a
    TensorFlow checkpoint in the reference's variable paths and TF's
    tensor-bundle format, with numpy alone: every leaf as float32 (fc_1's
    kernel as the reference's 1x1x1 conv kernel), a momentum slot
    (``.OPTIMIZER_SLOT/optimizer/momentum``) of random values from ``seed``
    per parameter, an int64 ``save_counter`` and a string
    ``_CHECKPOINTABLE_OBJECT_GRAPH``.  Returns ``{name: array}`` of the
    numeric tensors written."""
    import numpy as np

    from x3d_tpu_torch.convert import _flatten
    from x3d_tpu_torch.data.tfrecords import _varint

    rng = np.random.default_rng(seed)
    tensors = {}
    for path, leaf in _flatten(tree):
        name = reference_name(path)
        value = np.asarray(leaf, dtype=np.float32)
        if path[1] == "fc_1" and path[-1] == "kernel":
            value = value.reshape((1, 1, 1) + value.shape)
        tensors[name] = value
        if path[0] == "params":
            slot = name[:-len(REF_SUFFIX)] + "/.OPTIMIZER_SLOT/optimizer/" \
                "momentum" + REF_SUFFIX
            tensors[slot] = rng.normal(0, 1e-3, value.shape).astype(
                np.float32)
    tensors["save_counter" + REF_SUFFIX] = np.array(1, dtype=np.int64)
    graph = b"\n\x00"                     # the object graph, as a string
    dtypes = {np.dtype(np.float32): 1, np.dtype(np.int64): 9}
    entries, data, offset = [], bytearray(), 0
    for name in sorted(tensors, key=str.encode) + [
            "_CHECKPOINTABLE_OBJECT_GRAPH"]:
        if name in tensors:
            value = tensors[name]
            raw = value.astype(value.dtype.newbyteorder("<")).tobytes()
            dtype, crc = dtypes[value.dtype], _masked_crc32c(raw)
            shape = value.shape
        else:
            # DT_STRING: the lengths as varints, the masked CRC-32C of the
            # lengths as uint32s, the bytes; the entry's CRC runs over the
            # uint32 lengths, that CRC and the bytes
            size = len(graph).to_bytes(4, "little")
            length_crc = _masked_crc32c(size).to_bytes(4, "little")
            raw = _varint(len(graph)) + length_crc + graph
            crc = _masked_crc32c(size + length_crc + graph)
            dtype, shape = 7, ()
        dims = b"".join(_pb(2, 2, _pb(1, 0, d)) for d in shape)
        proto = _pb(1, 0, dtype) + _pb(2, 2, dims) + \
            (_pb(4, 0, offset) if offset else b"") + _pb(5, 0, len(raw)) + \
            _pb(6, 5, crc)
        entries.append((name.encode(), proto))
        data += raw
        offset += len(raw)
    entries.sort()
    header = _pb(1, 0, 1) + _pb(3, 2, _pb(1, 0, 1))   # 1 shard, producer 1
    entries.insert(0, (b"", header))
    # data blocks of about BUNDLE_BLOCK_BYTES, an index of their last keys
    index, blocks, run, size = bytearray(), [], [], 0
    for key, value in entries:
        run.append((key, value))
        size += len(key) + len(value) + 3
        if size >= BUNDLE_BLOCK_BYTES:
            blocks.append(run)
            run, size = [], 0
    if run:
        blocks.append(run)

    def put(block: bytes) -> bytes:
        handle = _varint(len(index)) + _varint(len(block))
        index.extend(block + b"\x00" + _masked_crc32c(block + b"\x00")
                     .to_bytes(4, "little"))
        return handle

    tops = [(run[-1][0], put(_table_block(run, BUNDLE_RESTART_EVERY)))
            for run in blocks]
    meta = put(_table_block([], 1))
    top = put(_table_block(tops, 1))
    footer = (meta + top).ljust(40, b"\x00") + \
        BUNDLE_MAGIC.to_bytes(8, "little")
    with open(prefix + ".data-00000-of-00001", "wb") as f:
        f.write(data)
    with open(prefix + ".index", "wb") as f:
        f.write(bytes(index) + footer)
    return tensors


def _tool(module: str, *args: str):
    """Run ``python -m x3d_tpu_torch.tools.<module> args`` from the
    repository root: (return code, stdout, stderr, wall seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"x3d_tpu_torch.tools.{module}", *args],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    return proc.returncode, proc.stdout, proc.stderr, \
        time.perf_counter() - t0


def import_phase(emit, check) -> dict:
    """Phase 11d: the reference's TF checkpoints into the port.  Writes
    X3D-M's every variable (random float32 from the seed, full width and
    depth) in the reference's variable paths and TF's bundle format, with
    momentum slots, a save counter and the object graph
    (:func:`write_reference_checkpoint`); runs the import tool with
    ``--verify_only`` and then into a model folder, and ``tools/predict
    --synthetic`` on that folder, each as a process of its own; checks that
    every leaf the engine restores from the folder equals the array written
    bit for bit, that a bfloat16 1-video request through the kernels gives
    probabilities (K1 5, K2 22, K7 57 launches) and that a float32 forward
    through the kernels equals the plain one on the imported weights; and
    that ``tools/summary --variant M`` writes ``model_summaries/X3D_M.txt``
    byte for byte.  Returns the phase's row (the request's launches under
    ``request_launches``)."""
    import numpy as np
    import torch

    from x3d_tpu_torch import convert, variant_config
    from x3d_tpu_torch.models import build_arch, create_model
    from x3d_tpu_torch.ops import plain_versions
    from x3d_tpu_torch.serving import InferenceEngine
    from x3d_tpu_torch.tools import tf_bundle

    config = "x3d_tpu_torch/configs/kinetics/X3D_M.yaml"
    cfg = variant_config("M")
    arch = build_arch(cfg)
    rng = np.random.default_rng(SEED)
    tree = convert.state_dict_to_flax(create_model(
        cfg, dtype=torch.float32, device="cpu", init=False).state_dict())
    draw = {"scale": lambda s: rng.uniform(0.5, 1.5, s),
            "var": lambda s: rng.uniform(0.5, 1.5, s),
            "mean": lambda s: rng.normal(0, 0.1, s),
            "bias": lambda s: rng.normal(0, 0.1, s)}
    for path, leaf in convert._flatten(tree):
        fill = draw.get(path[-1], lambda s: rng.normal(0, 0.05, s))
        node = tree
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = fill(leaf.shape).astype(np.float32)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_import_") as d:
        prefix = os.path.join(d, "model")
        t0 = time.perf_counter()
        written = write_reference_checkpoint(prefix, tree)
        write_s = time.perf_counter() - t0
        bundle_bytes = {ext: os.path.getsize(prefix + ext) for ext in
                        (".index", ".data-00000-of-00001")}
        with tf_bundle.load_checkpoint(prefix, "cuda") as reader:
            index_blocks = reader.num_blocks
        n_model = sum(1 for _ in convert._flatten(tree))
        n_other = len(written) - n_model + 1          # + the object graph

        rc_v, out_v, err_v, verify_s = _tool(
            "import_tf_checkpoint", f"--ckpt={prefix}", f"--config={config}",
            "--verify_only")
        verify = json.loads(out_v.splitlines()[-1]) if rc_v == 0 else None
        check(verify == {"mapped": n_model, "skipped": n_other, "errors": 0},
              f"import --verify_only: rc {rc_v}, {verify}, want "
              f"{n_model} mapped, {n_other} skipped: {err_v[-2000:]}")
        folder = os.path.join(d, "imported")
        rc_i, out_i, err_i, import_s = _tool(
            "import_tf_checkpoint", f"--ckpt={prefix}", f"--config={config}",
            f"--output={folder}")
        imported = json.loads(out_i.splitlines()[-1]) if rc_i == 0 else None
        check(rc_i == 0 and imported["leaves"] == n_model
              and os.path.exists(os.path.join(folder, "checkpoints",
                                              "ckpt-0.pt")),
              f"import: rc {rc_i}, {imported}: {err_i[-2000:]}")
        rc_p, out_p, err_p, predict_s = _tool(
            "predict", f"--cfg={config}", f"--model_folder={folder}",
            "--synthetic", "--max_batches=1", "--batch_videos=1")
        rows = [json.loads(ln) for ln in out_p.splitlines()
                if ln.startswith("{")]
        check(rc_p == 0 and len(rows) == 1 and all(
            np.isfinite(r["probs"]).all() for r in rows),
            f"predict on the imported folder: rc {rc_p}, {rows}: "
            f"{err_p[-2000:]}")

        # every leaf the engine restores equals the array written
        engine = InferenceEngine.from_checkpoint(cfg, folder, max_videos=1)
        got = convert.state_dict_to_flax(engine.model.state_dict())
        differ = [reference_name(path)
                  for path, leaf in convert._flatten(got)
                  if not np.array_equal(leaf, written[reference_name(
                      path)].reshape(leaf.shape))]
        check(not differ and engine.model.dtype == torch.bfloat16,
              f"imported leaves differ from the checkpoint: {differ[:5]}")

        # a bfloat16 1-video request through the kernels
        clips = np.random.RandomState(SEED).randint(
            0, 255, engine.clip_shape, dtype=np.uint8)
        zero_counts()
        probs = engine.predict(clips)
        launches = read_counts()
        row_err = float(np.abs(probs.sum(-1) - 1.0).max())
        n_k2 = sum(len(b) - 1 for b in arch.stages)
        want = dict.fromkeys(launches, 0) | {
            "K1": len(arch.stages) + 1, "K2": n_k2,
            "K7": 2 * (len(arch.stages) + n_k2) + len(arch.stages) + 1}
        check(probs.shape == (1, cfg.NETWORK.NUM_CLASSES)
              and bool(np.isfinite(probs).all()) and row_err <= TOL_ROW_SUM,
              f"imported X3D-M probabilities: row error {row_err}")
        check(launches == want, f"imported X3D-M request launches "
                                f"{launches}, want {want}")

        # float32 forward through the kernels against the plain versions
        engine32 = InferenceEngine(cfg, engine.model.state_dict(),
                                   max_videos=1, dtype=torch.float32)
        p_kernels = engine32.predict(clips)
        with plain_versions():
            p_plain = engine32.predict(clips)
        err = float(np.abs(p_kernels - p_plain).max())
        check(err <= TOL_PROBS_F32,
              f"imported X3D-M f32 probs kernels vs plain err {err}")
        del engine, engine32
        torch.cuda.empty_cache()

        # the summary tool's golden file
        golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "model_summaries", "X3D_M.txt")
        rc_s, _, err_s, _ = _tool("summary", "--variant=M",
                                  f"--output_dir={d}")
        with open(golden, "rb") as f:
            want_text = f.read()
        summary_path = os.path.join(d, "X3D_M.txt")
        same = rc_s == 0 and os.path.exists(summary_path) and \
            open(summary_path, "rb").read() == want_text
        check(same, f"tools/summary --variant M differs from {golden}: "
                    f"{err_s[-2000:]}")

    row = dict(variant="M", tensors_written=len(written) + 1,
               model_variables=n_model, bundle_bytes=bundle_bytes,
               bundle_total_bytes=sum(bundle_bytes.values()),
               index_blocks=index_blocks,
               write_s=write_s, verify=verify, verify_wall_s=verify_s,
               import_wall_s=import_s, imported=imported,
               predict_wall_s=predict_s, predict_top=rows[0]["top"][:5]
               if rows else None, leaves_differing=len(differ),
               request_launches=launches, max_row_sum_err=row_err,
               f32_kernels_vs_plain=err, summary_equal=same)
    emit(phase="import: reference TF checkpoint into X3D-M", **row)
    return row


def _parallel_rank(rank, world, data, model_ax, sync_bn, dropout, init,
                   out_dir):
    """One rank of phase 12(b), in a spawned process: gloo on cuda:0 beside
    the other rank, the float32 X3D-M step (seeded weights, the seeded
    PARITY_CLIPS batch, its share of it) through the kernels; writes the
    loss, the gradients and the state after the step (the head's shards
    joined) and the kernels' launches to ``out_dir/rank<R>.pt``."""
    import torch

    from x3d_tpu_torch import parallel, variant_config
    from x3d_tpu_torch.data import synthetic_batches
    from x3d_tpu_torch.models import create_model
    from x3d_tpu_torch.parallel import mesh as pmesh
    from x3d_tpu_torch.train import create_train_state, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = parallel.init_mesh(data, model_ax, rank=rank, world_size=world,
                              init_method=init, backend="gloo",
                              device="cuda:0")
    cfg = variant_config("M")
    cfg.TPU.SYNC_BN = sync_bn
    if not dropout:
        cfg.NETWORK.DROPOUT_RATE = 0.0
    model = create_model(cfg, dtype=torch.float32, seed=SEED + 1, mesh=mesh)
    state = create_train_state(cfg, model)
    step = make_train_step(model, cfg.NETWORK.WEIGHT_DECAY)
    batch = next(synthetic_batches(cfg, PARITY_CLIPS, dtype=torch.float32,
                                   seed=SEED + 1, device=mesh.device))
    zero_counts()
    state, metrics = step(state, parallel.shard_batch(batch, mesh),
                          torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    launches = read_counts()
    grads = {n: p.grad for n, p in model.named_parameters()}
    for n, dim in model.head_split.items():
        grads[n] = pmesh.gather_split(grads[n], dim, mesh)
    out = {"loss": float(metrics["loss"]), "launches": launches,
           "grads": {n: g.cpu() for n, g in grads.items()},
           "state": {n: t.cpu() for n, t in
                     parallel.full_model_state(model).items()}}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    parallel.barrier(mesh)
    parallel.shutdown()


def _one_process_step(vcfg, bn_groups):
    """The float32 X3D-M step of :func:`_parallel_rank` in this process on
    the whole batch, through the kernels: (loss, gradients, state before,
    state after)."""
    import torch

    from x3d_tpu_torch.data import synthetic_batches
    from x3d_tpu_torch.models import create_model
    from x3d_tpu_torch.train import create_train_state, make_train_step

    model = create_model(vcfg, dtype=torch.float32, seed=SEED + 1,
                         bn_groups=bn_groups)
    state = create_train_state(vcfg, model)
    before = copy.deepcopy(model.state_dict())
    batch = next(synthetic_batches(vcfg, PARITY_CLIPS, dtype=torch.float32,
                                   seed=SEED + 1))
    _, metrics = make_train_step(model, vcfg.NETWORK.WEIGHT_DECAY)(
        state, batch, torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    out = (float(metrics["loss"]),
           {n: p.grad.clone() for n, p in model.named_parameters()},
           before, copy.deepcopy(model.state_dict()))
    del model, state
    torch.cuda.empty_cache()
    return out


def parallel_phase(emit, check) -> dict:
    """Phase 12: data parallelism, per-replica (grouped) BN and the split
    head on the one card.

    (a) Grouped statistics in one process: the float32 X3D-M step at
    PARITY_CLIPS with ``bn_groups = 2`` through the kernels against the
    plain versions (``f32_step_check``); the bfloat16 step at the config's
    batch with ``bn_groups`` 1 (synced), 2 and 4 (and 1 again, last): the
    launches and bodies of every step (the ungrouped plan), the step
    repeated bit for bit, finite losses, the median step's device ms, peak
    memory and the device's idle share in the same call.
    (b) Two ranks sharing the card over gloo (spawned processes, each on
    cuda:0 by an explicit device): ``SYNC_BN: True`` (2 x PARITY_CLIPS/2
    clips) against the one-process step on the whole batch, ``SYNC_BN:
    False`` against the one-process ``bn_groups = 2`` step, and the head
    split (data 1 x model 2, dropout on) against the one-process step, at
    ``f32_step_check``'s tolerances; every rank's parameters and
    statistics bit for bit equal across the ranks.
    (c) A one-rank NCCL group: ``tools/train --synthetic`` at X3D-S for 2
    steps under torchrun's environment (RANK 0 of WORLD_SIZE 1, a
    ``file://`` rendezvous) against the same tool run without a process
    group: the checkpoints' parameters, statistics and optimizer slots bit
    for bit.

    Returns the launches and bodies per bfloat16 step by ``bn_groups``
    for the ``kernels`` line."""
    import statistics

    import torch
    import torch.multiprocessing as mp

    from x3d_tpu_torch import variant_config
    from x3d_tpu_torch.data import synthetic_batches
    from x3d_tpu_torch.models import build_arch, create_model
    from x3d_tpu_torch.tools.trace import trace
    from x3d_tpu_torch.train import create_train_state, make_train_step

    cfg = variant_config("M")
    arch = build_arch(cfg)
    want = want_step_of(arch, True, "off")

    # ----------------------------------- (a) grouped statistics, one process
    f32_step_check(emit, check, cfg, "M", want, bn_groups=2,
                   label="grouped BN (bn_groups 2) X3D-M ")
    batch = next(synthetic_batches(cfg, TRAIN_CLIPS, seed=SEED))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, by_groups = [], {}
    for g in PAR_GROUPS:
        model = create_model(cfg, dtype=torch.bfloat16, seed=SEED,
                             bn_groups=g)
        state = create_train_state(cfg, model)
        step_fn = make_train_step(model, cfg.NETWORK.WEIGHT_DECAY)
        snap = snapshot(state)
        step_fn(state, batch, gen)                        # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        times, losses, per_step = [], [], []
        for _ in range(PAR_TIMED_STEPS):
            before = read_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, metrics = step_fn(state, batch, gen)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            losses.append(float(metrics["loss"]))
            after = read_counts()
            per_step.append({k: after[k] - before[k] for k in after})
        launches, bodies = read_counts(), read_bodies()
        peak = torch.cuda.max_memory_allocated()
        summary = trace(lambda: step_fn(state, batch, gen), n=2,
                        unit="step", warmup=0)
        runs = []
        for _ in range(2):
            restore(state, snap)
            state, metrics = step_fn(state, batch, gen)
            runs.append((float(metrics["loss"]),
                         [p.grad.clone() for p in model.parameters()],
                         copy.deepcopy(model.state_dict())))
        repeat = (runs[0][0] == runs[1][0]
                  and all(torch.equal(a, b)
                          for a, b in zip(runs[0][1], runs[1][1]))
                  and all(torch.equal(runs[0][2][k], v)
                          for k, v in runs[1][2].items()))
        row = {"bn_groups": g, "clips": TRAIN_CLIPS, "step_ms": times,
               "step_ms_median": statistics.median(times),
               "peak_memory_bytes": peak,
               "idle_share": summary["idle_share"],
               "device_busy_ms_per_step":
                   summary["device_busy_ms_per_step"],
               "family_ms_per_step": summary["family_ms_per_step"],
               "losses": losses, "repeat_bit_identical": repeat,
               "launches_per_step": want, "bodies": bodies}
        rows.append(row)
        by_groups.setdefault(g, {"launches": launches, "bodies": bodies})
        emit(phase="parallel: X3D-M bf16 step by bn_groups", **row)
        check(all(math.isfinite(v) for v in losses),
              f"bn_groups {g}: losses {losses}")
        check(all(n == want for n in per_step),
              f"bn_groups {g}: launches {per_step}, want {want}")
        want_b = bodies_of_steps(cfg, arch, want, PAR_TIMED_STEPS, True,
                                 "off")
        for k, w in want_b.items():
            check(bodies[k] == w, f"bn_groups {g}: {k} bodies {bodies[k]}, "
                                  f"want {w}")
        check(repeat, f"bn_groups {g}: two runs of one step differ")
        del model, state, step_fn, snap, runs
        torch.cuda.empty_cache()
    synced = [r["step_ms_median"] for r in rows if r["bn_groups"] == 1]
    sync_ms = statistics.mean(synced)
    ratios = {r["bn_groups"]: r["step_ms_median"] / sync_ms
              for r in rows if r["bn_groups"] != 1}
    peaks = {r["bn_groups"]: r["peak_memory_bytes"] - max(
        q["peak_memory_bytes"] for q in rows if q["bn_groups"] == 1)
        for r in rows if r["bn_groups"] != 1}
    emit(phase="parallel: grouped vs synced X3D-M bf16 step",
         synced_step_ms=synced, step_ms_ratio_to_synced=ratios,
         peak_bytes_over_synced=peaks,
         prediction_ratio_range=[0.95, 1.10], prediction_peak_bytes=2e8,
         prediction_met={g: 0.95 <= ratios[g] <= 1.10 and peaks[g] <= 2e8
                         for g in ratios})
    del batch
    torch.cuda.empty_cache()

    # ----------------------------- (b) two ranks sharing the card, gloo
    ctx = mp.get_context("spawn")
    refs = {}
    for *_, dropout, groups in PAR_RUNS:
        vcfg = variant_config("M")
        if not dropout:
            vcfg.NETWORK.DROPOUT_RATE = 0.0
        key = (dropout, groups)
        if key not in refs:
            refs[key] = _one_process_step(vcfg, groups)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gloo_") as d:
        started = {}
        for name, dp, mp_, sync, dropout, _ in PAR_RUNS:
            out_dir = os.path.join(d, name)
            os.makedirs(out_dir)
            init = "file://" + os.path.join(out_dir, "rendezvous")
            started[name] = [ctx.Process(
                target=_parallel_rank,
                args=(r, dp * mp_, dp, mp_, sync, dropout, init, out_dir))
                for r in range(dp * mp_)]
            for p in started[name]:
                p.start()
        for procs in started.values():
            for p in procs:
                p.join(PAR_RANK_TIMEOUT_S)
                if p.is_alive():
                    p.terminate()
                    p.join()
        for name, dp, mp_, sync, dropout, groups in PAR_RUNS:
            codes = [p.exitcode for p in started[name]]
            check(codes == [0] * len(codes),
                  f"two ranks {name}: exit codes {codes}")
            if codes != [0] * len(codes):
                continue
            outs = [torch.load(os.path.join(d, name, f"rank{r}.pt"),
                               weights_only=True)
                    for r in range(len(codes))]
            loss_w, grads_w, before, after_w = refs[dropout, groups]
            grads_w = {n: g.cpu() for n, g in grads_w.items()}
            before = {n: t.cpu() for n, t in before.items()}
            after_w = {n: t.cpu() for n, t in after_w.items()}
            got = outs[0]
            loss_err = abs(got["loss"] - loss_w) / abs(loss_w)
            g_l2, g_leaf, g_cos = grad_diff(got["grads"], grads_w)
            u_l2, u_leaf = update_diff(got["state"], after_w, before,
                                       grads_w)
            s_err = stats_err(got["state"], after_w)
            same = all(torch.equal(o["state"][k], v) for o in outs[1:]
                       for k, v in got["state"].items())
            emit(phase=f"parallel: two gloo ranks on one card, {name}",
                 data=dp, model=mp_, sync_bn=sync, dropout=dropout,
                 against=f"one process, bn_groups {groups}, "
                         f"{PARITY_CLIPS} clips",
                 loss_ranks=got["loss"], loss_one_process=loss_w,
                 loss_rel_err=loss_err, grad_rel_l2=g_l2,
                 grad_worst_leaf_rel_l2=g_leaf, grad_least_leaf_cosine=g_cos,
                 update_rel_l2=u_l2, update_worst_leaf_rel_l2=u_leaf,
                 stats_err_of_leaf_max=s_err, ranks_bit_identical=same,
                 launches_by_rank=[o["launches"] for o in outs])
            what = f"two ranks {name}"
            check(loss_err <= TOL_STEP_LOSS, f"{what}: loss err {loss_err}")
            check(g_l2 <= TOL_STEP_L2 and g_leaf <= TOL_STEP_LEAF_L2
                  and g_cos >= TOL_STEP_COS,
                  f"{what}: grads rel L2 {g_l2}, worst leaf {g_leaf}, "
                  f"least cosine {g_cos}")
            check(u_l2 <= TOL_STEP_L2 and u_leaf <= TOL_STEP_LEAF_L2,
                  f"{what}: update rel L2 {u_l2}, worst leaf {u_leaf}")
            check(s_err <= TOL_STEP_STATS, f"{what}: stats err {s_err}")
            check(same, f"{what}: the ranks' parameters differ")
            check(all(o["launches"][k] > 0 for o in outs
                      for k in ("K2", "K3", "K5", "K6")),
                  f"{what}: launches {[o['launches'] for o in outs]}")
    del refs
    torch.cuda.empty_cache()

    # ------------------------------------- (c) a one-rank NCCL group
    # the two runs at once (a step is deterministic whatever shares the
    # card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as d:
        runs = {}
        for name, env in (("without a process group", {}),
                          ("one-rank NCCL group", {
                              "RANK": "0", "WORLD_SIZE": "1",
                              "LOCAL_RANK": "0"})):
            model_dir = os.path.join(d, "group" if env else "none")
            extra = [f"--init_method=file://{d}/rendezvous",
                     "--num_gpus=1"] if env else []
            runs[name] = (model_dir, bool(env), time.perf_counter(),
                          subprocess.Popen(
                [sys.executable, "-m", "x3d_tpu_torch.tools.train",
                 "--config=x3d_tpu_torch/configs/kinetics/X3D_S.yaml",
                 "--synthetic", f"--model_dir={model_dir}",
                 "--steps_per_epoch=2", "--epochs=1", *extra],
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True, cwd=os.path.dirname(os.path.abspath(__file__)),
                env={**os.environ, **env}))
        states, walls = [], {}
        for name, (model_dir, grouped, t0, proc) in runs.items():
            try:
                _, err = proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                proc.kill()
                _, err = proc.communicate()
            walls[name] = time.perf_counter() - t0
            check(proc.returncode == 0,
                  f"tools.train {name}: rc {proc.returncode}, {err[-2000:]}")
            path = os.path.join(model_dir, "checkpoints", "ckpt-2.pt")
            states.append(torch.load(path, map_location="cpu",
                                     weights_only=True)
                          if os.path.exists(path) else None)
            if grouped:
                check("nccl" in err,
                      f"tools.train {name}: no NCCL group in its log")
        same = None not in states and states[0]["step"] == \
            states[1]["step"] == 2 and all(
                torch.equal(states[0]["model"][k], v)
                for k, v in states[1]["model"].items()) and all(
                torch.equal(states[0]["optimizer"]["state"][i][k], v)
                for i, slots in states[1]["optimizer"]["state"].items()
                for k, v in slots.items())
        emit(phase="parallel: X3D-S tool, one-rank NCCL group vs none",
             steps=2, bit_identical=same, wall_s=walls)
        check(same, "tools.train in a one-rank NCCL group differs from the "
                    "run without a process group")
    return by_groups


# Phase 13: the exported X3D-M programs.  Requests of 1 and 8 videos (10
# views each); the default programs and the engine timed by EXPORT_ITERS
# requests between CUDA events and by the median of EXPORT_WALL_SAMPLES
# requests' wall time; the portable ones (the plain versions: a check, not
# a speed figure) untimed; the host's cost of
# an x3d:: op against a direct call of its launch function over
# EXPORT_OP_CALLS calls enqueued without a synchronise (fewer than the
# launch queue holds).
EXPORT_VIDEOS = (1, 8)
EXPORT_RUNS = (("float32", False), ("bfloat16", False), ("float32", True),
               ("bfloat16", True))
EXPORT_ITERS = 10
EXPORT_WALL_SAMPLES = 5
EXPORT_OP_CALLS = 200
EXPORT_TIMEOUT_S = 600
# the portable program against the engine's plain forward: the same ATen
# ops, but cuDNN may pick another algorithm in another process
TOL_PORTABLE = {"float32": 1e-4, "bfloat16": 2e-2}


def serve_want(vcfg, varch, clips, dtype_name):
    """K1's, K2's and K7's launches by body in one serving forward of
    ``clips`` clips of X3D-``vcfg`` in ``dtype_name``: K1 the temporal
    body at the stem and the ring body at the stage entries, K2 the ring
    body at every stride-1 block, K7 as its plan names."""
    elem = 4 if dtype_name == "float32" else 2
    return {"K1": {"temporal": 1, "ring": len(varch.stages), "generic": 0},
            "K2": {"ring": sum(len(b) - 1 for b in varch.stages),
                   "generic": 0},
            "K7": k7_want(vcfg, varch, False, 1, clips=clips, elem=elem)}


def _export_worker(export_dir, out_path, card_lock):
    """Phase 13, in a spawned process: load ``serve_videos`` of the export
    in ``export_dir`` (``export.load``, onto the card) and, holding
    ``card_lock`` (the processes load at once and take the card in turns),
    serve the requests of EXPORT_VIDEOS videos: launches and bodies a
    forward, probabilities against the engine's at the same batch (the
    default program bit for bit, the portable one against the plain
    forward), the device and wall ms of both (default programs), the
    graph's x3d:: ops.  Writes a JSON row to ``out_path``."""
    import collections

    import torch

    from x3d_tpu_torch import export, variant_config
    from x3d_tpu_torch.models import build_arch, create_model

    t0 = time.perf_counter()
    program = export.load(export_dir)
    load_s = time.perf_counter() - t0
    meta = program.meta
    dtype = getattr(torch, meta["dtype"])
    cfg = variant_config("M")
    arch = build_arch(cfg)
    graph_ops = collections.Counter(
        str(n.target) for n in program.module.graph.nodes
        if n.op == "call_function" and str(n.target).startswith("x3d."))
    aten_only = all(str(n.target).startswith(("aten.", "<built-in"))
                    for n in program.module.graph.nodes
                    if n.op == "call_function")
    model = create_model(cfg, dtype=dtype, seed=SEED)
    with card_lock:
        rows = _export_requests(program, model, cfg, arch, meta, dtype)
    with open(out_path, "w") as f:
        json.dump({"meta": meta, "load_wall_s": load_s,
                   "graph_ops": dict(graph_ops), "aten_only": aten_only,
                   "rows": rows}, f)


def _export_requests(program, model, cfg, arch, meta, dtype):
    """:func:`_export_worker`'s requests, one row each."""
    import numpy as np
    import torch

    from x3d_tpu_torch.ops import plain_versions
    from x3d_tpu_torch.ops.timing import time_fn
    from x3d_tpu_torch.serving import InferenceEngine

    plain = plain_versions if meta["portable"] else contextlib.nullcontext

    def wall_ms(fn, clips):
        fn(clips)
        times = []
        for _ in range(EXPORT_WALL_SAMPLES):
            t = time.perf_counter()
            fn(clips)
            times.append(time.perf_counter() - t)
        return float(np.median(times)) * 1e3

    rows = []
    for videos in EXPORT_VIDEOS:
        clips = np.random.RandomState(SEED + videos).randint(
            0, 255, (videos * meta["views"], *meta["clip"]), dtype=np.uint8)
        x = torch.from_numpy(clips).cuda()
        program(x)
        torch.cuda.synchronize()
        zero_counts()
        probs = program(x)
        torch.cuda.synchronize()
        launches, bodies = read_counts(), read_bodies()
        engine = InferenceEngine(cfg, model, max_videos=videos, dtype=dtype)
        with plain():
            want = engine.predict(clips)
        got = probs.cpu().numpy()
        timed = {}
        if not meta["portable"]:
            timed = {
                "device_ms": time_fn(program, x, iters=EXPORT_ITERS) * 1e3,
                "engine_device_ms": engine.device_latency_s(
                    iters=EXPORT_ITERS) * 1e3,
                "wall_ms": wall_ms(lambda c: program(
                    torch.from_numpy(c).cuda()).cpu(), clips),
                "engine_wall_ms": wall_ms(engine.predict, clips)}
        rows.append({
            "videos": videos, "clips": len(clips),
            "shape": list(got.shape), "finite": bool(np.isfinite(got).all()),
            "max_row_sum_err": float(np.abs(got.sum(-1) - 1).max()),
            "equal_engine": bool(np.array_equal(got, want)),
            "max_abs_err_engine": float(np.abs(got - want).max()),
            "launches": {k: launches[k] for k in ("K1", "K2", "K7")},
            "other_launches": sum(v for k, v in launches.items()
                                  if k not in ("K1", "K2", "K7")),
            "bodies": {k: bodies[k] for k in ("K1", "K2", "K7")},
            "want_bodies": serve_want(cfg, arch, len(clips), meta["dtype"]),
            **timed})
        del engine
        torch.cuda.empty_cache()
    return rows


def _op_host_us(emit, check):
    """At X3D-M's 1-video bfloat16 shapes (the stem's conv_t, a stage-2
    fused segment, stage 2's conv a): each x3d:: op through
    ``torch.library.opcheck`` (its schema, and its fake version against
    the kernel's output), its output against a direct call of its launch
    function, and the host's microseconds a call of each."""
    import torch

    from x3d_tpu_torch import variant_config
    from x3d_tpu_torch.models import build_arch
    from x3d_tpu_torch.ops import depthwise, dw_fused, library, pointwise

    cfg = variant_config("M")
    arch = build_arch(cfg)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    T, S = cfg.DATA.TEMP_DURATION, cfg.DATA.TEST_CROP_SIZE // 2
    b0 = arch.stages[0][0]
    kt = arch.temp_filter

    def rand(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    x1 = rand(CLIPS, T, S, S, arch.conv1_dim)
    k1 = torch.randn((kt, 1, 1, 1, arch.conv1_dim), generator=g,
                     device="cuda")
    pads1 = ((kt // 2, kt // 2), (0, 0), (0, 0))
    S2 = S // 2
    C = b0.inner_channels
    x2 = rand(CLIPS, T, S2, S2, C)
    cols = torch.rand((C, CLIPS), generator=g, device="cuda")
    k2 = torch.randn((arch.temp_kernel, 3, 3, 1, C), generator=g,
                     device="cuda")
    x7 = rand(CLIPS, T, S, S, b0.in_channels)
    w7 = rand(C, b0.in_channels)
    pads = [v for p in pads1 for v in p]
    # name: (the op's arguments, its launch function and that's arguments)
    calls = {"depthwise_conv3d": ((x1, k1, [1, 1, 1], pads),
                                  depthwise.depthwise_conv3d,
                                  (x1, k1, (1, 1, 1), pads1)),
             "dw_bn_act_conv": ((x2, cols, cols, k2),
                                dw_fused.dw_bn_act_conv, (x2, cols, cols, k2)),
             "pw_conv": ((x7, w7, [1, 1, 1]), pointwise.pw_conv,
                         (x7, w7, (1, 1, 1)))}

    def outputs(t):
        return t if isinstance(t, tuple) else (t,)

    out, opcheck = {}, {}
    for name, (args, launch, launch_args) in calls.items():
        op = getattr(library, name)
        try:
            torch.library.opcheck(op, args, test_utils=("test_schema",
                                                        "test_faketensor"))
            opcheck[name] = "passed"
        except Exception as e:              # reported, and failed below
            opcheck[name] = f"{type(e).__name__}: {e}"[:500]
        check(opcheck[name] == "passed",
              f"opcheck x3d::{name} on the card: {opcheck[name]}")
        same = all(torch.equal(a, b) for a, b in zip(
            outputs(op(*args)), outputs(launch(*launch_args))))
        check(same, f"x3d::{name}: the op's output differs from a direct "
                    "call's")
        us = {}
        for label, fn, fn_args in (("op", op, args),
                                   ("direct", launch, launch_args)) * 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(EXPORT_OP_CALLS):
                fn(*fn_args)
            us.setdefault(label, []).append(
                (time.perf_counter() - t0) / EXPORT_OP_CALLS * 1e6)
            torch.cuda.synchronize()
        out[name] = {"op_us": min(us["op"]), "direct_us": min(us["direct"]),
                     "extra_us": min(us["op"]) - min(us["direct"]),
                     "same_output": same}
    emit(phase="export: host us a call, x3d:: op vs direct", calls=out,
         calls_timed=EXPORT_OP_CALLS, opcheck=opcheck)
    return out


def export_phase(emit, check) -> dict:
    """Phase 13: the serving forward exported (A11b).  ``tools/export``
    writes X3D-M (full width and depth, 16x224², 10 views, random weights
    from the seed) in float32 and bfloat16, default and ``--portable``,
    each as a process of its own (the four at once); each export's
    ``serve_videos`` is loaded in a fresh process (:func:`_export_worker`;
    the four load at once and take the card in turns) and serves 1 and 8
    videos: the default program's probabilities equal the engine's at the
    same batch bit for bit, with K1 5, K2 22 and K7 57 launches a forward
    by the bodies the plan names, timed beside the engine; the portable
    program launches none and is within TOL_PORTABLE of the plain forward.
    Also: a tiny program traced on the CPU (while the tool runs), moved
    onto the card by ``export.load`` and run through the kernels against
    the engine; and the ops on the card (:func:`_op_host_us`).  Returns
    {"launches": the default programs' K1/K2/K7 launches a 1-video forward
    by dtype, "op_host_us": the ops' host cost, "phase_wall_s"}."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from x3d_tpu_torch import export, variant_config
    from x3d_tpu_torch.models import build_arch, create_model
    from x3d_tpu_torch.serving import InferenceEngine

    config = "x3d_tpu_torch/configs/kinetics/X3D_M.yaml"
    cfg = variant_config("M")
    arch = build_arch(cfg)
    n_k2 = sum(len(b) - 1 for b in arch.stages)
    root = os.path.dirname(os.path.abspath(__file__))
    out = {"launches": {}}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as d:
        # ------------------------------ the four exports, processes at once
        procs = {}
        t_all = time.perf_counter()
        for dtype, portable in EXPORT_RUNS:
            name = f"{dtype}{'_portable' if portable else ''}"
            argv = [sys.executable, "-m", "x3d_tpu_torch.tools.export",
                    f"--cfg={config}", f"--model_folder={d}/no_run",
                    f"--export_dir={d}/{name}", f"--dtype={dtype}",
                    "--allow_random_init"] + (["--portable"] if portable
                                              else [])
            procs[name] = (subprocess.Popen(
                argv, cwd=root, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True), time.perf_counter())
        # meanwhile, a tiny program traced on the CPU (served below)
        tiny = variant_config("XS")
        tiny.NETWORK.C1_CHANNELS = 8
        tiny.NETWORK.DEPTH_FACTOR = 0.34
        tiny.DATA.TEMP_DURATION = 4
        tiny.DATA.TEST_CROP_SIZE = 32
        tiny.TEST.NUM_TEMPORAL_VIEWS = 2
        tiny_state = create_model(tiny, dtype=torch.float32, device="cpu",
                                  seed=SEED).state_dict()
        tiny_dir = os.path.join(d, "tiny_cpu")
        export.export_program(tiny, tiny_state, tiny_dir, device="cpu")
        exported = {}
        for name, (proc, t0) in procs.items():
            try:
                stdout, stderr = proc.communicate(timeout=EXPORT_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                stdout, stderr = proc.communicate()
            wall = time.perf_counter() - t0
            path = os.path.join(d, name)
            ok = proc.returncode == 0 and stdout.strip().endswith(path)
            check(ok, f"tools/export {name}: rc {proc.returncode}: "
                      f"{stderr[-2000:]}")
            exported[name] = {
                "rc": proc.returncode, "wall_s": wall,
                "bytes": {f: os.path.getsize(os.path.join(path, f))
                          for f in sorted(os.listdir(path))} if ok else None}
        emit(phase="export: X3D-M by tools/export", exports=exported,
             all_four_wall_s=time.perf_counter() - t_all)

        # ------------------------- each loaded in a fresh process, served
        ctx = mp.get_context("spawn")
        card_lock = ctx.Lock()
        started = {n: ctx.Process(target=_export_worker, args=(
            os.path.join(d, n), os.path.join(d, n + ".json"), card_lock))
            for n in exported if exported[n]["rc"] == 0}
        for p in started.values():
            p.start()
        codes = {}
        for n, p in started.items():
            p.join(EXPORT_TIMEOUT_S)
            if p.is_alive():
                p.terminate()
                p.join()
            codes[n] = p.exitcode
        for name in exported:
            code = codes.get(name)
            check(code == 0, f"exported {name}: the loading process exited "
                             f"{code}")
            if code != 0:
                continue
            with open(os.path.join(d, name + ".json")) as f:
                got = json.load(f)
            meta = got["meta"]
            for row in got["rows"]:
                where = f"exported X3D-M {name}, {row['videos']} video(s)"
                check(row["finite"] and row["max_row_sum_err"] <= TOL_ROW_SUM
                      and row["shape"] == [row["videos"],
                                           cfg.NETWORK.NUM_CLASSES],
                      f"{where}: probabilities {row['shape']}, row error "
                      f"{row['max_row_sum_err']}")
                if meta["portable"]:
                    check(not any(row["launches"].values())
                          and row["other_launches"] == 0,
                          f"{where}: the portable program launched "
                          f"{row['launches']}")
                    check(row["max_abs_err_engine"]
                          <= TOL_PORTABLE[meta["dtype"]],
                          f"{where}: vs the plain forward "
                          f"{row['max_abs_err_engine']}")
                else:
                    want = {k: sum(v.values())
                            for k, v in row["want_bodies"].items()}
                    check(row["launches"] == want
                          and want == {"K1": len(arch.stages) + 1,
                                       "K2": n_k2,
                                       "K7": 3 * len(arch.stages)
                                       + 2 * n_k2 + 1},
                          f"{where}: launches {row['launches']}, want {want}")
                    check(row["bodies"] == row["want_bodies"],
                          f"{where}: bodies {row['bodies']}, want "
                          f"{row['want_bodies']}")
                    check(row["equal_engine"], f"{where}: differs from the "
                          f"engine by {row['max_abs_err_engine']}")
                    if row["videos"] == 1:
                        out["launches"][meta["dtype"]] = row["launches"]
            if meta["portable"]:
                check(got["aten_only"] and not got["graph_ops"],
                      f"exported {name}: the portable graph holds "
                      f"{got['graph_ops']}")
            else:
                check(got["graph_ops"] == {
                    "x3d.depthwise_conv3d.default": len(arch.stages) + 1,
                    "x3d.dw_bn_act_conv.default": n_k2,
                    "x3d.pw_conv.default": 3 * len(arch.stages) + 2 * n_k2
                    + 1}, f"exported {name}: graph ops {got['graph_ops']}")
            emit(phase="export: X3D-M served from the program", export=name,
                 **got)

        # ---------- traced on the CPU, moved onto the card, through kernels
        program = export.load(tiny_dir)
        clips = np.random.RandomState(SEED).randint(
            0, 255, (4, 4, 32, 32, 3), dtype=np.uint8)
        zero_counts()
        got = program(torch.from_numpy(clips).cuda())
        moved_launches = read_counts()
        engine = InferenceEngine(tiny, tiny_state, max_videos=2,
                                 dtype=torch.float32)
        want = engine.predict(clips)
        moved = {"device": str(got.device),
                 "launches": {k: moved_launches[k]
                              for k in ("K1", "K2", "K7")},
                 "equal_engine": bool(np.array_equal(got.cpu().numpy(),
                                                     want))}
        check(got.is_cuda and moved["equal_engine"]
              and all(moved["launches"].values()),
              f"a program traced on the CPU, moved onto the card: {moved}")
        emit(phase="export: traced on the CPU, served on the card", **moved)
    out["op_host_us"] = _op_host_us(emit, check)
    out["phase_wall_s"] = time.perf_counter() - t_phase
    emit(phase="export: phase 13's wall seconds", seconds=out["phase_wall_s"])
    return out


# Phase 14: raw videos and the dataset tools.  MJPEG AVIs (the format the
# card machine can decode: it has no video library) in a class-per-folder
# tree of 4 classes at INPUT_SIZES, 30 fps, every other video 12 s (the
# writer's 10-s trim) and the rest 10 s; one of them split into an OpenDML
# RIFF 'AVIX' continuation.
RAW_VIDEOS = 16
RAW_CLASSES = 4
RAW_FPS = 30
RAW_FRAMES = (360, 300)       # 12 s and 10 s at RAW_FPS, alternating
RAW_AVIX = 5                  # this video's second half in a RIFF 'AVIX'
RAW_BARE = 6                  # this one's frames without Huffman tables
RAW_STEPS = 2                 # X3D-M training steps from the text list
RAW_RATE_BATCHES = 8          # loader batches timed, text list and shards
M_CONFIG = "x3d_tpu_torch/configs/kinetics/X3D_M.yaml"
CLIP_REPLACES = ("no TPU kernel: x3d_tpu/data/pipeline.py:142 (tf.data "
                 "resize and crop, on the host) and x3d_tpu/data/device.py:17 "
                 "(XLA normalise)")


def _riff(fourcc: bytes, data: bytes) -> bytes:
    """One RIFF chunk, padded to an even size."""
    import struct

    return fourcc + struct.pack("<I", len(data)) + data \
        + (b"\0" if len(data) & 1 else b"")


def write_mjpeg_avi(path: str, jpegs, width: int, height: int,
                    rate: int = RAW_FPS, scale: int = 1,
                    avix_at=None) -> None:
    """Write JPEG frames as a Motion-JPEG AVI: ``RIFF 'AVI '`` with the
    stream header (``dwRate / dwScale`` frames a second, ``dwLength`` the
    frames given), ``LIST 'movi'`` of ``00dc`` chunks (an empty bytes
    object is a zero-length chunk, a dropped frame) and ``idx1``; frames
    from ``avix_at`` on go into an OpenDML ``RIFF 'AVIX'`` part."""
    import struct

    n = len(jpegs)
    first = list(jpegs if avix_at is None else jpegs[:avix_at])
    avih = struct.pack("<14I", int(1e6 * scale / rate), 0, 0, 0x10, n, 0, 1,
                       0, width, height, 0, 0, 0, 0)
    strh = b"vids" + b"MJPG" + struct.pack(
        "<IHHIIIIIIIIhhhh", 0, 0, 0, 0, scale, rate, 0, n, 0, 0xFFFFFFFF, 0,
        0, 0, width, height)
    strf = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 24, b"MJPG",
                       width * height * 3, 0, 0, 0, 0)
    hdrl = _riff(b"LIST", b"hdrl" + _riff(b"avih", avih) + _riff(
        b"LIST", b"strl" + _riff(b"strh", strh) + _riff(b"strf", strf)))
    movi = _riff(b"LIST", b"movi" + b"".join(_riff(b"00dc", j)
                                             for j in first))
    index, off = [], 4
    for j in first:
        index.append(b"00dc" + struct.pack("<III", 0x10, off, len(j)))
        off += 8 + len(j) + (len(j) & 1)
    with open(path, "wb") as f:
        f.write(_riff(b"RIFF", b"AVI " + hdrl + movi
                      + _riff(b"idx1", b"".join(index))))
        if avix_at is not None:
            f.write(_riff(b"RIFF", b"AVIX" + _riff(
                b"LIST", b"movi" + b"".join(_riff(b"00dc", j)
                                            for j in jpegs[avix_at:]))))


def _strip_huffman(blob: bytes) -> bytes:
    """A JPEG without its DHT segments, as camera MJPEG (``AVI1``) stores
    frames coded with the standard tables."""
    out, pos = bytearray(blob[:2]), 2
    while blob[pos + 1] != 0xDA:
        n = blob[pos + 2] << 8 | blob[pos + 3]
        if blob[pos + 1] != 0xC4:
            out += blob[pos:pos + 2 + n]
        pos += 2 + n
    return bytes(out + blob[pos:])


def raw_video_phase(emit, check) -> dict:
    """Phase 14: raw videos and the dataset tools.  Writes RAW_VIDEOS
    coded videos (``data.synthetic.coded_video``) as MJPEG AVIs on the card
    (nvJPEG; one with an OpenDML continuation, one Pillow-coded without
    Huffman tables) in a class-per-folder tree, runs ``tools/
    create_label`` (the tree, and a flat directory through an annotations
    JSON and the Kinetics-400 map), ``create_tfrecords`` and
    ``inspect_tfrecords`` as processes, trains X3D-M RAW_STEPS steps at 32
    clips from the text list (the clip kernel's and nvJPEG's launches
    counted over that run) and evaluates 10 views at 4 videos a batch from
    the list and from the shards; holds the text path's clips to the plain
    clip prep on nvJPEG's frames bit for bit and the sampled frames' codes
    to the sampler's indices; runs ``tools/train --nouse_tfrecord`` and
    ``tools/eval --notfrecord``; and times the loader on the list against
    the shards and a thread's record by stage.  Returns the clip kernel's
    raw-video row for the ``kernels`` line."""
    import os
    import statistics
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from PIL import Image

    from x3d_tpu_torch import variant_config
    from x3d_tpu_torch.data import InputReader, avi, tfrecords
    from x3d_tpu_torch.data.synthetic import coded_video, read_code
    from x3d_tpu_torch.models import create_model
    from x3d_tpu_torch.ops import clip_prep, jpeg
    from x3d_tpu_torch.tools import bench_loader
    from x3d_tpu_torch.tools import eval as eval_cli
    from x3d_tpu_torch.ops.timing import time_fn
    from x3d_tpu_torch.tools import train as train_cli
    from x3d_tpu_torch.tools.trace import LostTrace, family, trace
    from x3d_tpu_torch.train import create_train_state, make_train_step

    dev = torch.device("cuda")
    cfg_m = variant_config("M")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_raw_") as d:
        # ------------------------------------- the corpus, on the card
        corpus = os.path.join(d, "corpus")
        videos = [(os.path.join(corpus, f"class_{i % RAW_CLASSES}",
                                f"video_{i:02d}.avi"), i % RAW_CLASSES,
                   RAW_FRAMES[i % 2], INPUT_SIZES[i % 3])
                  for i in range(RAW_VIDEOS)]
        frames_of = {p: n for p, _, n, _ in videos}

        def write(i):
            path, label, n, (h, w) = videos[i]
            frames = coded_video(n, h, w, label, seed=i, device=dev)
            if i == RAW_BARE:
                jpegs = [_strip_huffman(j) for j in
                         jpeg.encode(frames.cpu().numpy(), 90, device="cpu")]
            else:
                jpegs = jpeg.encode(frames, 90, device=dev)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            write_mjpeg_avi(path, jpegs, w, h, rate=RAW_FPS,
                            avix_at=n // 2 if i == RAW_AVIX else None)
            return sum(len(j) for j in jpegs)

        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:
            nbytes = sum(pool.map(write, range(RAW_VIDEOS)))
        write_s = time.perf_counter() - t0
        headers = []
        for path, _, n, _ in videos:
            a = avi.open_mjpeg(path)
            headers.append(a is not None and (a.count, len(a), a.fps)
                           == (n, n, float(RAW_FPS)))
        emit(phase="raw videos: MJPEG AVIs written on the card",
             videos=RAW_VIDEOS, classes=RAW_CLASSES, frames=list(RAW_FRAMES),
             fps=RAW_FPS, sizes=[list(s) for s in INPUT_SIZES],
             seconds=write_s, mb=nbytes / 2**20, avix_video=RAW_AVIX,
             no_huffman_tables_video=RAW_BARE, headers_as_written=headers)
        check(all(headers), f"raw videos: AVI headers read back {headers}")

        # ------------------------------- the dataset tools, as processes
        train_txt = os.path.join(d, "train.txt")
        listed = sorted(videos, key=lambda v: (v[1], v[0]))
        rc, _, err, label_s = _tool("create_label", f"--video_root={corpus}",
                                    f"--output={train_txt}")
        lines = [ln.rsplit(" ", 1) for ln in open(train_txt).read()
                 .splitlines()] if rc == 0 else []
        tree_ok = [(p, int(l)) for p, l in lines] \
            == [(p, l) for p, l, *_ in listed]
        k400 = tfrecords.kinetics400_label_map()
        names = sorted(k400, key=k400.get)
        flat = os.path.join(d, "test")
        os.makedirs(flat)
        ann, want_test = {}, []
        for k, (path, *_) in enumerate(videos[:4]):
            yid = f"yt{k:08d}"
            os.symlink(path, os.path.join(flat, f"{yid}.avi"))
            cls = names[(97 * k + 11) % len(names)]
            ann[yid] = {"annotations": {"label": cls.replace("_", " ")}}
            want_test.append((os.path.join(flat, f"{yid}.avi"), k400[cls]))
        ann_path = os.path.join(d, "test.json")
        with open(ann_path, "w") as f:
            json.dump(ann, f)
        test_txt = os.path.join(d, "test.txt")
        rc2, _, err2, _ = _tool("create_label", f"--video_root={flat}",
                                f"--output={test_txt}",
                                f"--test_json_file={ann_path}")
        test_ok = rc2 == 0 and [
            (p, int(l)) for p, l in (ln.rsplit(" ", 1) for ln in
                                     open(test_txt).read().splitlines())
        ] == want_test
        shards = os.path.join(d, "shards")
        rc3, _, err3, tf_s = _tool(
            "create_tfrecords", f"--label_file={train_txt}",
            f"--output_dir={shards}", "--prefix=train",
            "--videos_per_record=4", "--num_workers=4")
        names_ok = rc3 == 0 and sorted(os.listdir(shards)) == [
            f"train-{k:05d}.tfrecord" for k in range(RAW_VIDEOS // 4)]
        recs = []
        for name in sorted(os.listdir(shards)) if rc3 == 0 else []:
            for rec in tfrecords.read_shard(os.path.join(shards, name),
                                            jpeg.crc32c):
                v = tfrecords.SequenceExampleView(rec)
                recs.append((v.label, v.num_frames, v.stored_frames(),
                             bytes(v.frame(0)),
                             bytes(v.frame(v.stored_frames() - 1))))
        kept = [min(n, int(10 * RAW_FPS)) for _, _, n, _ in listed]
        frames_ok = [(l, n, m) for l, n, m, *_ in recs] \
            == [(l, k, k) for (_, l, *_), k in zip(listed, kept)]
        # the first and last kept frame of each record, by their codes
        ends = []
        for (l, n, _, first, last), (_, _, _, (h, w)) in zip(recs, listed):
            arena, offs = jpeg.decode_batch([first, last], [(h, w)] * 2, dev)
            got = torch.stack([arena[o:o + h * w * 3].view(h, w, 3)
                               for o in offs])
            ends.append(read_code(got).tolist() == [[0, l], [n - 1, l]])
        gifs = os.path.join(d, "gifs")
        rc4, _, err4, inspect_s = _tool(
            "inspect_tfrecords", f"--cfg={M_CONFIG}",
            f"--file_pattern={os.path.join(shards, 'train-*')}",
            f"--output_dir={gifs}")
        gif_rows = []
        for name in sorted(os.listdir(gifs)) if rc4 == 0 else []:
            img = Image.open(os.path.join(gifs, name))
            gif_rows.append([name, img.n_frames, list(img.size)])
        crop = cfg_m.DATA.TRAIN_CROP_SIZE
        gifs_ok = len(gif_rows) == 4 and all(
            r[0].startswith(f"sample{k}_label")
            and r[1:] == [cfg_m.DATA.TEMP_DURATION, [crop, crop]]
            for k, r in enumerate(gif_rows))
        emit(phase="raw videos: create_label, create_tfrecords, "
                   "inspect_tfrecords", rc=[rc, rc2, rc3, rc4],
             tree_labels_ok=tree_ok, test_labels_ok=test_ok,
             shards_named_ok=names_ok, frames_per_record=[r[1] for r in recs],
             records_ok=frames_ok, first_last_codes_ok=all(ends),
             gifs=gif_rows, create_tfrecords_wall_s=tf_s,
             inspect_wall_s=inspect_s, create_label_wall_s=label_s,
             stderr_tail=[e[-400:] for e, r in ((err, rc), (err2, rc2),
                                                (err3, rc3), (err4, rc4))
                          if r])
        check(rc == rc2 == rc3 == rc4 == 0 and tree_ok and test_ok
              and names_ok and frames_ok and all(ends) and gifs_ok,
              f"raw videos: the dataset tools: rc {[rc, rc2, rc3, rc4]}, "
              f"labels {tree_ok} {test_ok}, shards {names_ok} {frames_ok} "
              f"{ends}, gifs {gif_rows}")

        # -------------- X3D-M trained from the text list (counted launches)
        model = create_model(cfg_m, seed=SEED, device=dev)
        state = create_train_state(cfg_m, model)
        step_fn = make_train_step(model, cfg_m.NETWORK.WEIGHT_DECAY)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        readers = [InputReader(cfg_m, True, seed=SEED, device=dev,
                               use_tfrecord=False)]
        readers[0].keep_last = True
        it = readers[0](train_txt, cfg_m.TRAIN.BATCH_SIZE)
        clip_prep.clip_prep.launches = 0
        jpeg.decode_batch.launches = 0
        losses = []
        for s in range(RAW_STEPS):
            batch = next(it)
            if s == 0:
                first, first_plan = batch["video"], readers[0].last
            state, metrics = step_fn(state, batch, gen)
            losses.append(float(metrics["loss"]))
        it.close()
        torch.cuda.synchronize()
        launches = {"clip_prep": clip_prep.clip_prep.launches,
                    "nvjpeg_decode": jpeg.decode_batch.launches}
        emit(phase="raw videos: X3D-M trained from the text list",
             clips=cfg_m.TRAIN.BATCH_SIZE, steps=RAW_STEPS, losses=losses,
             launches=launches)
        check(all(math.isfinite(x) for x in losses)
              and launches == {"clip_prep": RAW_STEPS + 1,
                               "nvjpeg_decode": RAW_STEPS + 1},
              f"raw videos: X3D-M from the text list: {losses} {launches}")

        # ---------- 10 views from the text list and from the shards
        model.eval()
        readers.append(InputReader(cfg_m, False, device=dev,
                                   use_tfrecord=False))
        readers[1].keep_last = True
        runs = {}
        for kind, reader, pattern in (
                ("text", readers[1], train_txt),
                ("shards", InputReader(cfg_m, False, device=dev),
                 os.path.join(shards, "train-*"))):
            labels, probs = [], []
            for b in reader(pattern, cfg_m.TEST.BATCH_SIZE):
                if kind == "text" and not labels:
                    eval_first, eval_plan = b["video"], reader.last
                with torch.no_grad():
                    probs.append(model(b["video"]).float())
                labels += b["label"].tolist()
            runs[kind] = (labels, torch.cat(probs))
        gap = (runs["text"][1] - runs["shards"][1]).abs().amax(dim=1)
        long = torch.tensor([n > int(10 * RAW_FPS) for _, _, n, _ in listed],
                            device=dev)
        same_order = runs["text"][0] == runs["shards"][0] \
            == [l for _, l, *_ in listed]
        emit(phase="raw videos: X3D-M 10-view eval, text list vs shards",
             videos=len(runs["text"][0]), same_labels_in_order=same_order,
             max_prob_gap_10s=float(gap[~long].max()),
             max_prob_gap_12s_trimmed=float(gap[long].max()),
             note="10-s videos: the same frames, the shards' q90 re-encode "
                  "apart; 12-s videos: the shards hold 10 s, so the views "
                  "sample other frames")
        check(same_order and bool(torch.isfinite(gap).all()),
              f"raw videos: eval labels {runs['text'][0]} vs "
              f"{runs['shards'][0]}")

        # --- the text path's clips: the plain clip prep, bit for bit; codes
        cases, worst = [], 0.0
        for name, training, video, plan in (
                ("X3D-M training, text list", True, first, first_plan),
                ("X3D-M eval 10 views, text list", False, eval_first,
                 eval_plan)):
            T = cfg_m.DATA.TEMP_DURATION
            S = video.shape[2]
            shape = (len(plan.table) // T, T, S, S, 3)
            args = (plan.arena, plan.table, shape)
            norm = (cfg_m.DATA.MEAN, cfg_m.DATA.STD)
            ref = clip_prep.clip_prep_reference(*args, torch.bfloat16, *norm)
            same = torch.equal(video, ref)
            same_u8 = torch.equal(clip_prep.clip_prep(*args, torch.uint8),
                                  clip_prep.clip_prep_reference(
                                      *args, torch.uint8))
            err = float((video.float() - ref.float()).abs().max())
            worst = max(worst, err)
            codes = read_back(plan, cfg_m, training,
                              lambda r: frames_of[r.key[0][0]])
            flips = sorted({int(f) for f in plan.table["flip"]})
            plain_ms = statistics.median(
                _wall_ms(lambda: clip_prep.clip_prep_reference(
                    *args, torch.bfloat16, *norm)) for _ in range(3))
            def kernel():
                return clip_prep.clip_prep(*args, torch.bfloat16, *norm)

            try:
                ms = trace(kernel, n=5, unit="call",
                           group=lambda n: "clip" if "clip_prep_kernel" in n
                           else family(n))["group_ms_per_call"].get("clip",
                                                                     0.0)
                timer = "profiler"
            except LostTrace:
                # late in a long process the profiler can lose every window
                # (tools/trace.py); CUDA events then time the call, its
                # synchronous upload of the map table included
                ms, timer = time_fn(kernel) * 1e3, "events"
            nbytes = clip_prep.bound_bytes(plan.table, shape, torch.bfloat16)
            flops = 12 * int(np.prod(shape))
            t_mem, t_ops = nbytes / MEM_BYTES_PER_S, flops / F32_FLOP_PER_S
            row = {"case": name, "clips": shape[0], "shape": list(shape),
                   "decoded_frames": len(plan.offsets),
                   "bit_for_bit_uint8": same_u8, "bit_for_bit_bf16": same,
                   "max_abs_err": err, "flips": flips,
                   "codes_read_back": codes, "ms": ms, "timer": timer,
                   "plain_ms": plain_ms,
                   "bound_ms": max(t_mem, t_ops) * 1e3,
                   "bound_by": "bytes" if t_mem >= t_ops else "operations",
                   "bound_bytes": nbytes}
            cases.append(row)
            emit(phase="raw videos: clip kernel vs plain", **row)
            check(same and same_u8, f"raw videos: clip kernel differs from "
                                    f"its plain version: {name}")
            check(codes, f"raw videos: sampled frames' codes wrong: {name}")
            if training:
                check(flips == [0, 1], f"raw videos: training flips {flips}")
        del first, first_plan, eval_first, eval_plan, runs

        # ------------------------------------- the tools' text-list paths
        with tempfile.TemporaryDirectory() as run_dir:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc_train = train_cli.main(
                    [f"--config={M_CONFIG}", f"--model_dir={run_dir}",
                     "--nouse_tfrecord", f"--train_file_pattern={train_txt}",
                     "--steps_per_epoch=2", "--epochs=1"])
                rc_eval = eval_cli.main(
                    [f"--cfg={M_CONFIG}", f"--model_folder={run_dir}",
                     "--notfrecord", f"--test_file_pattern={test_txt}",
                     "--max_batches=1"])
            evals = [json.loads(ln) for ln in buf.getvalue().splitlines()
                     if ln.startswith("{")]
        emit(phase="raw videos: tools/train --nouse_tfrecord, tools/eval "
                   "--notfrecord", rc=[rc_train, rc_eval], eval=evals)
        check(rc_train == rc_eval == 0 and len(evals) == 1
              and evals[0]["count"] == 4.0,
              f"raw videos: the tools on text lists: {rc_train} {rc_eval} "
              f"{evals}")

        # ------------- the loader alone: text list against shards, in turns
        rates = {"text list": [], "shards": []}
        for kind in ("text list", "shards", "shards", "text list"):
            text = kind == "text list"
            rates[kind].append(bench_loader.loader_rate(
                cfg_m, train_txt if text else os.path.join(shards, "train-*"),
                32, RAW_RATE_BATCHES, None, dev, use_tfrecord=not text))
        split = bench_loader.video_thread_split(cfg_m, train_txt, dev)
        emit(phase="raw videos: loader alone, text list vs shards",
             host_cores=os.cpu_count(), batches=RAW_RATE_BATCHES,
             rates=rates, thread_ms_per_record=split)
        substituted = sum(r.substituted for r in readers)
        check(substituted == 0, f"raw videos: {substituted} videos given "
                                "as zeros")
    wall = time.perf_counter() - t_phase
    emit(phase="raw videos: phase 14's wall seconds", seconds=wall)
    m = cases[0]
    return {"launches": launches["clip_prep"],
            "nvjpeg_decode_launches": launches["nvjpeg_decode"],
            "path": f"X3D-M training from a text list of MJPEG AVIs, "
                    f"{RAW_STEPS} steps",
            "max_abs_err": worst, "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "cases": cases, "substituted": substituted,
            "loader_clips_per_s": {k: [r["clips_per_s"] for r in v]
                                   for k, v in rates.items()},
            "phase_wall_s": wall}


def fold_phase(emit, check) -> dict:
    """Phase 11e: the time-folded layout on the card, at X3D-M's 1-video
    request (10 clips of 16x224², bfloat16, random weights from the seed).
    The port runs one body for every layout (a folded (B·T, 1, H, W, C)
    tensor is the NDHWC one's memory), so the phase checks what can
    differ: ``depthwise_conv3d_folded`` launches K1 on the folded view of
    stage 2's depthwise input (160 x 1 x 56² x 54), bit for bit K1 on the
    NDHWC tensor and within TOL_BF16 of the plain version; and the
    engine's five settings (None, True, False, "mixed", "measure") resolve
    to JAX's layouts (None folds a 10-clip request; "measure" keeps the
    unfolded one, the layouts tying) and each serves a request bit for bit
    the unfolded engine's, with the same launches and bodies.  Returns
    the layouts and K1's launches and error."""
    import numpy as np
    import torch

    from x3d_tpu_torch import variant_config
    from x3d_tpu_torch.ops import depthwise
    from x3d_tpu_torch.serving import InferenceEngine

    cfg = variant_config("M")
    views = cfg.TEST.NUM_TEMPORAL_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    base = InferenceEngine.random_init(cfg, max_videos=1, seed=SEED,
                                       time_fold=False)
    kernel = base.model.stage2_block1.bottleneck.b.kernel.detach()
    T, S, C = cfg.DATA.TEMP_DURATION, cfg.DATA.TEST_CROP_SIZE // 4, \
        kernel.shape[-1]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((views * T, 1, S, S, C), generator=g,
                    device="cuda").bfloat16()
    with torch.no_grad():
        zero_counts()
        got = depthwise.depthwise_conv3d_folded(x, kernel, T)
        k1 = read_counts()["K1"]
        logical = x.view(views, T, S, S, C)
        want = depthwise.depthwise(logical, kernel)
        pads = depthwise._resolve_pads(logical.shape, kernel.shape[:3],
                                       (1, 1, 1), "SAME")
        ref = depthwise.depthwise_conv3d_reference(
            logical.float(), kernel.bfloat16().float(), (1, 1, 1), pads)
    same = got.shape == (views * T, 1, S, S, C) and torch.equal(
        got, want.view(got.shape))
    rel = ((got.view(ref.shape).float() - ref).abs().max()
           / ref.abs().max()).item()
    out = {"k1_launches": k1, "k1_bit_for_bit_unfolded": same,
           "k1_rel_err_bf16": rel}
    emit(phase="fold: K1 on a folded view", shape=list(x.shape), **out)
    check(k1 == 1, f"fold: the folded conv launched K1 {k1} times")
    check(same, "fold: the folded conv differs from K1 on NDHWC")
    check(rel <= TOL_BF16, f"fold: the folded conv's error {rel}")

    clips = np.random.default_rng(SEED).integers(
        0, 256, (views,) + base.clip_shape[1:], dtype=np.uint8)
    zero_counts()
    want_probs = base.predict(clips)
    want_runs = (read_counts(), read_bodies())
    expect = {None: True, True: True, False: False, "mixed": "mixed",
              "measure": False}
    out["layouts"] = {}
    for setting, layout in expect.items():
        engine = InferenceEngine(cfg, base.model, max_videos=1,
                                 time_fold=setting)
        zero_counts()
        probs = engine.predict(clips)
        runs = (read_counts(), read_bodies())
        out["layouts"][str(setting)] = engine.layout
        check(engine.layout == layout, f"fold: time_fold {setting!r} "
                                       f"gave layout {engine.layout!r}")
        check(np.array_equal(probs, want_probs) and runs == want_runs,
              f"fold: the request with time_fold {setting!r} differs")
    check(want_runs[0]["K2"] > 0, "fold: no K2 launch in the request")
    emit(phase="fold: X3D-M engine layouts", clips=views,
         layouts=out["layouts"], launches=want_runs[0])
    del base, x, got, want, ref
    torch.cuda.empty_cache()
    return out


# PERF.md section 6's bound column: ms a bfloat16 X3D-M training step at 32
# clips, summed over each kernel's launches
STEP_BOUND_MS = {"K1": 0.6694, "K2": 0.7516, "K3": 1.5027, "K4 dx": 0.4853,
                 "K4 dk": 0.4853, "K5": 0.5431, "K6": 0.5431, "K7": 1.493,
                 "K8": 0.2761}
TOOLS_MEMORY_TOL = 0.02       # the memory tool's peak against phase 11's
TOOLS_BOUND_TOL = 0.01        # roofline's bound against STEP_BOUND_MS


def tools_phase(emit, check, peaks=None) -> dict:
    """The developer tools (phase 15), each through its own entry point:
    ``tools/memory`` at X3D-L, 16 clips, remat off / block / stage / convs
    (the peaks ordered block < convs < off; where ``peaks``, phase 11's
    {mode: peak bytes} of the same steps above what the script held before
    them, as the tool counts its own, off, block and convs within 2% of
    them); ``tools/ab`` at X3D-M: 32 clips through the kernels (5 steps)
    and through their plain versions (2 steps; the kernels ahead), and a
    1-video eval; ``tools/profile`` on an X3D-M training step at 32 clips
    (2 steps) into a temporary directory, ``--analyze_only`` on it (the
    same text) and ``tools/roofline`` on it (exit 0: no share above 1.05),
    whose launches per step equal the launch counters' and whose bound per
    step for K1-K8 is STEP_BOUND_MS's within 1%."""
    from x3d_tpu_torch import variant_config
    from x3d_tpu_torch.tools import ab, memory, profile, roofline
    from x3d_tpu_torch.tools import trace as trace_mod

    t0 = time.perf_counter()
    out = {"memory": {}, "ab": {}}
    # --------------------------------------------- memory at X3D-L, 16 clips
    cfg_l = variant_config("L")
    for mode in ("off", "block", "stage", "convs"):
        r = memory.analyze(cfg_l, 16, "train", mode)
        emit(phase="tools: memory", variant="L", **r)
        out["memory"][mode] = r
    total = {m: r["total_gb"] for m, r in out["memory"].items()}
    check(total["block"] < total["convs"] < total["off"],
          f"tools.memory X3D-L peaks out of order: {total}")
    if peaks:
        for mode, peak in peaks.items():
            check(abs(total[mode] * 1e9 / peak - 1) <= TOOLS_MEMORY_TOL,
                  f"tools.memory X3D-L {mode}: {total[mode]} GB against "
                  f"phase 11's {peak / 1e9} GB")

    # ------------------------------------------------------- ab at X3D-M
    for name, args, kw in (("kernels", ("M", "kernels", 32, 5), {}),
                           ("eval", ("M", "kernels", 1, 5),
                            {"mode": "eval"}),
                           ("plain", ("M", "plain", 32, 2), {})):
        r = ab.run_ab(*args, **kw)
        emit(phase="tools: ab", **r)
        out["ab"][name] = r
    check(out["ab"]["kernels"]["step_ms"] < out["ab"]["plain"]["step_ms"],
          f"tools.ab X3D-M: the kernels' step behind the plain versions': "
          f"{out['ab']}")

    # ------------------------------- profile and roofline, X3D-M training
    group_key = {g: k for k, g in trace_mod.RECORD_GROUPS.items()}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as d:
        lost = trace_mod.trace.lost
        zero_counts()                       # the profile tool starts here
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            profile.main(["--config", M_CONFIG, "--mode=train", "--batch=32",
                          "--steps=2", "--trace_dir", d])
        counts = read_counts()              # ... and ends here
        # two warm-up steps, then two steps a window taken
        steps_run = 2 + 2 * (1 + trace_mod.trace.lost - lost)
        again = io.StringIO()
        with contextlib.redirect_stdout(again):
            profile.main(["--analyze_only", d])
        report = io.StringIO()
        with contextlib.redirect_stdout(report):
            rc = roofline.main(["--trace_dir", d])
        groups = roofline.groups(roofline.load_device_events(d))
    emit(phase="tools: profile", variant="M", clips=32, steps=2,
         windows_retaken=trace_mod.trace.lost - lost,
         analysis=text.getvalue().splitlines(),
         analyze_only_same=again.getvalue() == text.getvalue())
    emit(phase="tools: roofline", variant="M", clips=32, rc=rc,
         report=report.getvalue().splitlines())
    check(again.getvalue() == text.getvalue(),
          "tools.profile --analyze_only printed another text than the "
          "capture")
    check(rc == 0, f"tools.roofline exit {rc}: a share above 1.05")
    rows = {}
    for g, r in groups.items():
        key = group_key.get(g)
        if key is None:
            continue
        row = {"launches_per_step": r["launches"] / 2,
               "counter_per_step": counts[key] / steps_run,
               "ms_per_step": r["ms"] / 2,
               "bound_ms_per_step": r["bound_ms"] / 2,
               "section6_bound_ms": STEP_BOUND_MS[key],
               "bound_by": r["bound_by"], "share": r["share"]}
        rows[key] = row
        emit(phase="tools: roofline, kernel", kernel=key, **row)
        check(row["launches_per_step"] == row["counter_per_step"],
              f"tools.roofline {key}: {row['launches_per_step']} launches a "
              f"step, the counter {row['counter_per_step']}")
        check(abs(row["bound_ms_per_step"] / STEP_BOUND_MS[key] - 1)
              <= TOOLS_BOUND_TOL,
              f"tools.roofline {key}: bound {row['bound_ms_per_step']} ms a "
              f"step, PERF.md's {STEP_BOUND_MS[key]}")
        check(row["share"] <= roofline.OVER,
              f"tools.roofline {key}: share {row['share']} above 1.05")
    check(sorted(rows) == sorted(STEP_BOUND_MS)
          and all(counts[k] for k in STEP_BOUND_MS),
          f"tools.roofline: kernels {sorted(rows)}")
    out["roofline"] = rows
    out["phase_s"] = time.perf_counter() - t0
    emit(phase="tools", seconds=out["phase_s"])
    return out


def _wall_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


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
        from x3d_tpu_torch.ops import (depthwise, dw_fused, epilogue,
                                       plain_versions, pointwise, pw_stats)
        from x3d_tpu_torch.ops.timing import time_fn
        from x3d_tpu_torch.serving import InferenceEngine
        from x3d_tpu_torch.tools import eval as eval_cli
        from x3d_tpu_torch.tools import fma_probe
        from x3d_tpu_torch.tools import predict as predict_cli
        from x3d_tpu_torch.tools import profile_pointwise
        from x3d_tpu_torch.tools import train as train_cli
        from x3d_tpu_torch.tools.trace import family, trace
        from x3d_tpu_torch.train import (create_train_state, make_eval_step,
                                         make_train_step)
        from x3d_tpu_torch.train.checkpoint import CheckpointManager
    except ImportError as e:
        print(f"chip_smoke: the x3d_tpu_torch package is missing ({e}); "
              "run from the repository root", file=sys.stderr)
        return 2

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card)
    failures = []

    t_start = time.perf_counter()

    def emit(**kw):
        # t_s: seconds since the card was found, to place each phase in the
        # script's time limit
        print(json.dumps({"card": card, "t_s": time.perf_counter() - t_start,
                          **kw}), flush=True)

    def check(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)
            print(f"chip_smoke: FAILED {what}", file=sys.stderr, flush=True)

    timing = {"iters": ITERS}

    def time_ms(fn, iters: int = 0) -> float:
        return time_fn(fn, iters=iters or timing["iters"]) * 1e3

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
    def ptxas_entries(sources, pattern, label):
        """One row per instantiation whose mangled name matches
        ``pattern``: registers, spills, static shared memory."""
        entries, name = [], None
        for source in sources:
            for ln in _build.build_logs.get(source, "").splitlines():
                m = re.search(r"entry function '.*?" + pattern, ln)
                if m:
                    name = label(m)
                elif name and "spill" in ln:
                    entries.append({"kernel": name, "spill_bytes": sum(
                        int(v) for v in re.findall(r"(\d+) bytes spill",
                                                   ln))})
                elif name and "Used" in ln:
                    regs = re.search(r"Used (\d+) registers", ln)
                    smem = re.search(r"(\d+) bytes smem", ln)
                    entries[-1].update(registers=int(regs[1]),
                                       static_smem_bytes=int(smem[1]) if smem
                                       else 0)
                    name = None
        return entries

    # the tensor-core kernels of K5-K7, one row per instantiation <copy
    # granule, mma column tiles a warp> (their ring and W slice are dynamic
    # shared memory: the rows' "plan")
    entries = ptxas_entries(("pw_stats.cu", "pointwise.cu"),
                            r"(pw_\w+_mma_kernel)ILi(\d+)ELi(\d+)E",
                            lambda m: f"{m[1]}<{m[2]}, {m[3]}>")
    emit(phase="build, tensor-core GEMM kernels", kernels=entries)
    # 27 instantiations: K5 and K6 x 3 granules x 3 column widths, K7 x 9
    check(len(entries) == 27 and all(
        e["spill_bytes"] == 0 and "registers" in e for e in entries),
        f"K5-K7 tensor-core kernels' ptxas report: {entries}")
    # K7's wg body, <column tile, consumer warpgroups>: 18 instantiations;
    # those that the X3D-M serving and training calls run must not spill
    entries = ptxas_entries(("pointwise.cu",),
                            r"pw_conv_wg_kernelILi(\d+)ELi(\d)E",
                            lambda m: f"pw_conv_wg_kernel<{m[1]}, {m[2]}>")
    emit(phase="build, K7 wg body", kernels=entries)
    x3d_m = variant_config("M")
    x3d_m_arch = build_arch(x3d_m)
    used = set()
    for train in (False, True):
        crop = x3d_m.DATA.TRAIN_CROP_SIZE if train \
            else x3d_m.DATA.TEST_CROP_SIZE
        found = profile_pointwise.cases(x3d_m, x3d_m_arch, CLIPS, crop, train)
        for _, shape, N, strides, _ in (profile_pointwise.with_dx(found)
                                        if train else found):
            M = shape[0] * shape[1] * -(-shape[2] // strides[1]) \
                * -(-shape[3] // strides[2])
            if pointwise.pw_body(shape[-1], N, M, strides, width=shape[3],
                                 height=shape[2]) == "wg":
                plane = None if strides == (1, 1, 1) else (
                    shape[0] * shape[1], *shape[2:4], *strides[1:])
                p = pointwise.wg_plan(M, shape[-1], N, plane=plane)
                used.add(f"pw_conv_wg_kernel<{p['block_columns']}, "
                         f"{p['consumers']}>")
    main = [e for e in entries if e["kernel"] in used]
    check(len(entries) == 18 and all("registers" in e for e in entries)
          and len(main) == len(used)
          and all(e["spill_bytes"] == 0 for e in main),
          f"K7 wg body's ptxas report: {entries}, used {sorted(used)}")
    # the same bodies built with the BN epilogue (its own library): the
    # pipe body's 9 instantiations, none spilling, and the wg body's 18,
    # those that an X3D-M serving forward's calls with an epilogue run
    # (all but the stride-1 blocks' conv a) not spilling
    ep_lib = _build.library_name("pointwise.cu", _build.BN_EPILOGUE)
    pipe_ep = ptxas_entries((ep_lib,), r"(pw_conv_mma_kernel)ILi(\d+)ELi(\d+)E",
                            lambda m: f"{m[1]}<{m[2]}, {m[3]}>")
    wg_ep = ptxas_entries((ep_lib,), r"pw_conv_wg_kernelILi(\d+)ELi(\d)E",
                          lambda m: f"pw_conv_wg_kernel<{m[1]}, {m[2]}>")
    emit(phase="build, K7 bodies with the BN epilogue",
         kernels=pipe_ep + wg_ep)
    used_ep = set()
    for name, shape, N, strides, _ in profile_pointwise.cases(
            x3d_m, x3d_m_arch, CLIPS, x3d_m.DATA.TEST_CROP_SIZE, False):
        M = shape[0] * shape[1] * -(-shape[2] // strides[1]) \
            * -(-shape[3] // strides[2])
        if not name.endswith("blocks' a") and pointwise.pw_body(
                shape[-1], N, M, strides, width=shape[3],
                height=shape[2]) == "wg":
            plane = None if strides == (1, 1, 1) else (
                shape[0] * shape[1], *shape[2:4], *strides[1:])
            p = pointwise.wg_plan(M, shape[-1], N, plane=plane,
                                  epilogue=True)
            used_ep.add(f"pw_conv_wg_kernel<{p['block_columns']}, "
                        f"{p['consumers']}>")
    main = [e for e in wg_ep if e["kernel"] in used_ep]
    check(len(pipe_ep) == 9 and len(wg_ep) == 18
          and all("registers" in e for e in pipe_ep + wg_ep)
          and len(main) == len(used_ep)
          and all(e["spill_bytes"] == 0 for e in pipe_ep + main),
          f"K7 with the BN epilogue, ptxas report: {pipe_ep + wg_ep}, "
          f"used {sorted(used_ep)}")
    # K4 dx's phase body, <element, channels a thread, temporal taps>
    entries = ptxas_entries(
        ("depthwise_bwd.cu",),
        r"dw_conv3d_dx_phase_kernelI(f|13__nv_bfloat16)Li(\d)ELi(\d)E",
        lambda m: "dw_conv3d_dx_phase_kernel<"
                  f"{'float' if m[1] == 'f' else 'bfloat16'}, {m[2]}, {m[3]}>")
    emit(phase="build, K4 dx phase body", kernels=entries)
    # 20 instantiations: 2 elements x 2 vector widths x kt 1 .. 5
    check(len(entries) == 20 and all(
        e["spill_bytes"] == 0 and "registers" in e for e in entries),
        f"K4 dx phase body's ptxas report: {entries}")
    # K4 dk's ring body, <element, channels a vector, temporal taps,
    # spatial stride>: 40 instantiations; the one every X3D stage entry runs
    # in bfloat16 (2 channels, kt 3, stride 2) must not spill
    entries = ptxas_entries(
        ("depthwise_bwd.cu",),
        r"dw_conv3d_dk_ring_kernelI(f|13__nv_bfloat16)Li(\d)ELi(\d)ELi(\d)E",
        lambda m: "dw_conv3d_dk_ring_kernel<"
                  f"{'float' if m[1] == 'f' else 'bfloat16'}, {m[2]}, {m[3]}, "
                  f"{m[4]}>")
    emit(phase="build, K4 dk ring body", kernels=entries)
    main = [e for e in entries
            if e["kernel"].endswith("<bfloat16, 2, 3, 2>")]
    check(len(entries) == 40 and all("registers" in e for e in entries)
          and len(main) == 1 and main[0]["spill_bytes"] == 0,
          f"K4 dk ring body's ptxas report: {entries}")
    # K3's ring body, <element, channels a thread, temporal taps>: 20
    # instantiations; the one every X3D segment runs in training (bfloat16,
    # 2 channels, kt 3) must not spill
    entries = ptxas_entries(
        ("dw_fused_bwd.cu",),
        r"dw_bn_act_conv_bwd_ring_kernelI(f|13__nv_bfloat16)Li(\d)ELi(\d)E",
        lambda m: "dw_bn_act_conv_bwd_ring_kernel<"
                  f"{'float' if m[1] == 'f' else 'bfloat16'}, {m[2]}, {m[3]}>")
    emit(phase="build, K3 ring body", kernels=entries)
    main = [e for e in entries
            if e["kernel"].endswith("<bfloat16, 2, 3>")]
    check(len(entries) == 20 and all("registers" in e for e in entries)
          and len(main) == 1 and main[0]["spill_bytes"] == 0,
          f"K3 ring body's ptxas report: {entries}")
    # K1's temporal body, <element, channels a cell, temporal taps>: 35
    # instantiations (float32 1, 2, 4 channels, bfloat16 1, 2, 4, 8; kt 1 ..
    # 5); the one every X3D stem runs in bfloat16 (16-byte cells, kt 5) must
    # not spill
    entries = ptxas_entries(
        ("depthwise.cu",),
        r"dw_conv3d_fwd_temporal_kernelI(f|13__nv_bfloat16)Li(\d)ELi(\d)E",
        lambda m: "dw_conv3d_fwd_temporal_kernel<"
                  f"{'float' if m[1] == 'f' else 'bfloat16'}, {m[2]}, {m[3]}>")
    emit(phase="build, K1 temporal body", kernels=entries)
    main = [e for e in entries
            if e["kernel"].endswith("<bfloat16, 8, 5>")]
    check(len(entries) == 35 and all("registers" in e for e in entries)
          and len(main) == 1 and main[0]["spill_bytes"] == 0,
          f"K1 temporal body's ptxas report: {entries}")
    # K1's ring body, <element, channels a vector, temporal taps, spatial
    # stride>: 40 instantiations; the one every X3D stage entry runs in
    # bfloat16 (2 channels, kt 3, stride 2) must not spill
    entries = ptxas_entries(
        ("depthwise.cu",),
        r"dw_conv3d_fwd_ring_kernelI(f|13__nv_bfloat16)Li(\d)ELi(\d)ELi(\d)E",
        lambda m: "dw_conv3d_fwd_ring_kernel<"
                  f"{'float' if m[1] == 'f' else 'bfloat16'}, {m[2]}, {m[3]}, "
                  f"{m[4]}>")
    emit(phase="build, K1 ring body", kernels=entries)
    main = [e for e in entries
            if e["kernel"].endswith("<bfloat16, 2, 3, 2>")]
    check(len(entries) == 40 and all("registers" in e for e in entries)
          and len(main) == 1 and main[0]["spill_bytes"] == 0,
          f"K1 ring body's ptxas report: {entries}")
    # K2's ring body, the same 20 instantiations; the one every X3D segment
    # runs (bfloat16, 2 channels, kt 3) must not spill
    entries = ptxas_entries(
        ("dw_fused.cu",),
        r"dw_bn_act_conv_fwd_ring_kernelI(f|13__nv_bfloat16)Li(\d)ELi(\d)E",
        lambda m: "dw_bn_act_conv_fwd_ring_kernel<"
                  f"{'float' if m[1] == 'f' else 'bfloat16'}, {m[2]}, {m[3]}>")
    emit(phase="build, K2 ring body", kernels=entries)
    main = [e for e in entries
            if e["kernel"].endswith("<bfloat16, 2, 3>")]
    check(len(entries) == 20 and all("registers" in e for e in entries)
          and len(main) == 1 and main[0]["spill_bytes"] == 0,
          f"K2 ring body's ptxas report: {entries}")

    # K8's temporal body, <element, channels a cell, temporal taps>: 15
    # instantiations (float32 1, 2 channels, bfloat16 1, 2, 4; kt 1, 3, 5);
    # the bfloat16 ones of 4 channels at kt 5 (the X3D stems') and 3 must
    # not spill
    entries = ptxas_entries(
        ("depthwise_pbwd.cu",),
        r"dw_conv3d_pbwd_temporal_kernelI(f|13__nv_bfloat16)Li(\d)ELi(\d)E",
        lambda m: "dw_conv3d_pbwd_temporal_kernel<"
                  f"{'float' if m[1] == 'f' else 'bfloat16'}, {m[2]}, {m[3]}>")
    emit(phase="build, K8 temporal body", kernels=entries)
    main = [e for e in entries
            if re.search(r"<bfloat16, 4, [35]>$", e["kernel"])]
    check(len(entries) == 15 and all("registers" in e for e in entries)
          and len(main) == 2 and all(e["spill_bytes"] == 0 for e in main),
          f"K8 temporal body's ptxas report: {entries}")

    if "--multigrid-only" in sys.argv[1:]:
        # the multigrid phase alone, after the build and the shards it reads
        with tempfile.TemporaryDirectory(prefix="chip_smoke_input_") as d:
            multigrid = multigrid_phase(emit, check,
                                        write_input_shards(emit, check, d))
        print(json.dumps({"card": card, "multigrid": {
            k: multigrid[k] for k in ("launches", "bodies")}}))
        if failures:
            fail(f"{len(failures)} check(s) failed: {failures}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if "--fold-only" in sys.argv[1:]:
        # the time-folded layout alone, after the build
        folded = fold_phase(emit, check)
        print(json.dumps({"card": card, "fold": folded}))
        if failures:
            fail(f"{len(failures)} check(s) failed: {failures}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if "--parallel-only" in sys.argv[1:]:
        # the data-parallel phase alone, after the build
        grouped = parallel_phase(emit, check)
        print(json.dumps({"card": card, "grouped_bn_x3d_m": grouped}))
        if failures:
            fail(f"{len(failures)} check(s) failed: {failures}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if "--import-only" in sys.argv[1:]:
        # the import phase alone, after the build
        imported = import_phase(emit, check)
        print(json.dumps({"card": card, "import": {
            k: imported[k] for k in ("request_launches", "import_wall_s",
                                     "bundle_total_bytes")}}))
        if failures:
            fail(f"{len(failures)} check(s) failed: {failures}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if "--export-only" in sys.argv[1:]:
        # the export phase alone, after the build
        exported = export_phase(emit, check)
        print(json.dumps({"card": card, "export": exported}))
        if failures:
            fail(f"{len(failures)} check(s) failed: {failures}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if "--tools-only" in sys.argv[1:]:
        # the developer tools' phase alone, after the build
        tools = tools_phase(emit, check)
        print(json.dumps({"card": card, "tools": tools}))
        if failures:
            fail(f"{len(failures)} check(s) failed: {failures}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if "--videos-only" in sys.argv[1:]:
        # the raw-video phase alone, after the build
        raw = raw_video_phase(emit, check)
        entry = {"name": "clip_prep", "route": "cuda",
                 "source": "x3d_tpu_torch/kernels/csrc/clip_prep.cu",
                 "replaces": CLIP_REPLACES, "library_ms": None,
                 **{k: raw[k] for k in ("launches", "path", "max_abs_err",
                                        "ms", "plain_ms", "bound_ms",
                                        "bound_by", "cases",
                                        "nvjpeg_decode_launches")}}
        print(json.dumps({"card": card, "kernels": [entry]}))
        if failures:
            fail(f"{len(failures)} check(s) failed: {failures}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if "--input-only" in sys.argv[1:]:
        # the input phase alone, after the build (a quicker check of it)
        entry = input_phase(emit, check)
        print(json.dumps({"card": card, "kernels": [entry]}))
        if failures:
            fail(f"{len(failures)} check(s) failed: {failures}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # the depthwise shapes of X3D-M and X3D-S, from their architecture plans
    cfg = variant_config("M")
    arch = build_arch(cfg)
    cfg_s = variant_config("S")
    arch_s = build_arch(cfg_s)

    def k1_cases(vcfg, varch, B):
        """(name, (B, T, H, W, C), kdims, strides, padding, launches per
        forward) of K1's launches in a serving forward: the stem's conv_t
        and the four stage entries."""
        T, S = vcfg.DATA.TEMP_DURATION, -(-vcfg.DATA.TEST_CROP_SIZE // 2)
        kt = varch.temp_filter
        cases = [("conv_1.conv_t", (B, T, S, S, varch.conv1_dim), (kt, 1, 1),
                  (1, 1, 1), ((kt // 2,) * 2, (0, 0), (0, 0)), 1)]
        for si, blocks in enumerate(varch.stages):
            cases.append((f"stage{si + 2}_block0.b",
                          (B, T, S, S, blocks[0].inner_channels),
                          (varch.temp_kernel, 3, 3), (1, 2, 2), "SAME", 1))
            S = -(-S // 2)
        return cases

    # K1 at the serving shapes: X3D-M and X3D-S, requests of 1 and 8 videos
    # (X3D-S's eval batch is 8 videos too); the 1-video X3D-M rows feed the
    # kernel line
    k1_paths = [(v, B, k1_cases(c, a_, B))
                for v, c, a_ in (("M", cfg, arch), ("S", cfg_s, arch_s))
                for B in (CLIPS, S_EVAL_CLIPS)]

    def segment_cases(vcfg, varch, B, crop):
        """(name, (B, T, H, W, C), launches per forward) of each stage's
        stride-1 blocks: the fused segments."""
        T, S = vcfg.DATA.TEMP_DURATION, crop // 2
        cases = []
        for si, blocks in enumerate(varch.stages):
            S = -(-S // 2)
            if len(blocks) > 1:
                cases.append((f"stage{si + 2} stride-1 blocks",
                              (B, T, S, S, blocks[0].inner_channels),
                              len(blocks) - 1))
        return cases

    # K2 at the serving shapes: X3D-M and X3D-S, requests of 1 and 8 videos
    # (X3D-S's eval batch is 8 videos too); the 1-video X3D-M rows feed the
    # kernel line
    k2_paths = [(v, B, a_.temp_kernel,
                 segment_cases(c, a_, B, c.DATA.TEST_CROP_SIZE))
                for v, c, a_ in (("M", cfg, arch), ("S", cfg_s, arch_s))
                for B in (CLIPS, S_EVAL_CLIPS)]
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def bn_coefs(C):
        """An eval BatchNorm's float32 (mul, add) from random running
        statistics: scales and variances 0.5 to 1.5, offsets and means of
        both signs."""
        scale = 0.5 + torch.rand(C, generator=gen, device="cuda")
        var = 0.5 + torch.rand(C, generator=gen, device="cuda")
        mul = scale / torch.sqrt(var + 1e-5)
        return mul, 0.3 * randn(C) - 0.2 * randn(C) * mul

    def epilogue_check(where, got, unfused, plain, mul, add, relu, tol):
        """A call with the BN epilogue: (values that differ from the same
        kernel's output without it through the plain epilogue, its
        largest distance from the plain conv in float32 through the plain
        epilogue over the largest |reference|), each checked."""
        want = epilogue.reference(unfused, mul, add, relu)
        differ = int((got != want).sum().item())
        ref = epilogue.reference(plain, mul, add, relu)
        err = ((got.float() - ref).abs().max() / ref.abs().max()).item()
        check(differ == 0, f"{where}: {differ} values differ from the "
              "launch without the epilogue through the plain epilogue")
        check(err <= tol, f"{where}: epilogue err {err}")
        return differ, err

    def shares(row):
        """bound_share: the bound over the kernel's time; vs_library: the
        kernel's time over the library call's."""
        return {"bound_share": row["bound_ms"] / row["ms"],
                "vs_library": row["ms"] / row["library_ms"]}

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
    k1_lib = _build.load("depthwise.cu", depthwise._SIGNATURES)

    def k1_times(xb, kb, strides, pads, n, plain=True, bn=None):
        """A bfloat16 K1 row's times and bound on these inputs: the body the
        wrapper picks and the generic body (what the new bodies replaced;
        its C entry point takes every geometry), both launched as the
        wrapper launches them on the same prepared taps, the body with the
        BN epilogue ``bn`` = (mul, add, relu) as serving launches it, the
        plain version and the library's ``F.conv3d(groups=C)``; with the
        body, its launch plan and the shares."""
        C = xb.shape[-1]
        kdims = tuple(kb.shape[:3])
        taps_f32 = kb.float().reshape(-1, C).contiguous()
        stream = torch.cuda.current_stream().cuda_stream

        def body_ms(body):
            return time_ms(lambda: depthwise._launch_fwd(
                k1_lib, body, xb, taps_f32, kdims, strides, pads, stream))

        row = dict(n=n, body=depthwise.fwd_body(kdims, strides, pads))
        row.update(ms=body_ms(row["body"]), generic_ms=body_ms("generic"))
        if bn is not None:
            coefs = epilogue.prepare(bn[0], bn[1], xb)
            ep_lib = epilogue.library("depthwise.cu", depthwise._SIGNATURES,
                                      coefs)
            row["epilogue"] = epilogue.kind(bn[0], bn[2])
            row["epilogue_ms"] = time_ms(lambda: depthwise._launch_fwd(
                ep_lib, row["body"], xb, taps_f32, kdims, strides, pads,
                stream, epilogue.pointers(coefs, bn[2])))
        out = [depthwise._out_size(d, kk, st, p) for d, kk, st, p in
               zip(xb.shape[1:4], kdims, strides, pads)]
        if row["body"] == "ring":
            row["plan"] = depthwise._ring_plan(k1_lib, xb, kdims[0],
                                               strides[1], out)
        elif row["body"] == "temporal":
            y = torch.empty((xb.shape[0], *out, C), dtype=xb.dtype,
                            device=xb.device)
            row["plan"] = depthwise._temporal_plan(k1_lib, xb, y, kdims[0],
                                                   out[0])
        if plain:
            row["plain_ms"] = time_ms(
                lambda: depthwise.depthwise_conv3d_reference(xb, kb, strides,
                                                             pads))
        # library yardstick: one F.conv3d(groups=C) on the channels-last
        # view; an asymmetric (TF SAME, stride 2) pad is applied beforehand
        xc, w = xb.permute(0, 4, 1, 2, 3), kb.permute(4, 3, 0, 1, 2)
        sym = all(lo == hi for lo, hi in pads)
        if not sym:
            (tl, th), (hl, hh), (wl, wh) = pads
            xc = F.pad(xc, (wl, wh, hl, hh, tl, th)).contiguous(
                memory_format=torch.channels_last_3d)
        lib_pad = tuple(lo for lo, _ in pads) if sym else 0
        row["library_ms"] = time_ms(lambda: F.conv3d(
            xc, w, stride=strides, padding=lib_pad, groups=C))
        row["library_pre_padded"] = not sym
        row["bound_ms"], row["bound_by"] = bound(*depthwise.fwd_cost(
            xb.shape, (xb.shape[0], *out, C), kdims, xb.element_size()))
        row.update(shares(row))
        return row

    def k1_serving_rows(variant, B, cases, plain):
        """K1 against its plain version at one serving batch's shapes,
        float32 and bfloat16, with the bfloat16 times (the plain version's
        where ``plain``)."""
        rows = []
        for name, shape, kdims, strides, padding, n in cases:
            C = shape[-1]
            x, k = randn(*shape), randn(*kdims, 1, C) * 0.3
            pads = depthwise._resolve_pads(shape, kdims, strides, padding)
            where = f"X3D-{variant} {B} clips {name}"
            # the BatchNorm after it as its epilogue, as serving launches
            # it: the stem's with the ReLU, bn_b at the stage entries
            mul, add = bn_coefs(C)
            relu = name == "conv_1.conv_t"
            ref = depthwise.depthwise_conv3d_reference(x, k, strides, pads)
            got = depthwise.depthwise_conv3d(x, k, strides, pads)
            torch.cuda.synchronize()
            err32 = (got - ref).abs().max().item()
            ep32 = epilogue_check(
                f"K1 {where} f32", depthwise.depthwise_conv3d(
                    x, k, strides, pads, mul, add, relu),
                got, ref, mul, add, relu, TOL_F32)
            xb, kb = x.bfloat16(), k.bfloat16()
            del x, k, ref, got
            refb = depthwise.depthwise_conv3d_reference(
                xb.float(), kb.float(), strides, pads)
            gotb = depthwise.depthwise_conv3d(xb, kb, strides, pads)
            rel16 = ((gotb.float() - refb).abs().max()
                     / refb.abs().max()).item()
            ep16 = epilogue_check(
                f"K1 {where} bf16", depthwise.depthwise_conv3d(
                    xb, kb, strides, pads, mul, add, relu),
                gotb, refb, mul, add, relu, TOL_BF16)
            del refb, gotb
            row = dict(variant=variant, clips=B, name=name, shape=list(shape),
                       kernel=list(kdims), strides=list(strides),
                       pads=[list(p) for p in pads], max_abs_err_f32=err32,
                       rel_err_bf16=rel16,
                       epilogue_bits_differ=ep32[0] + ep16[0],
                       epilogue_err_f32=ep32[1], epilogue_err_bf16=ep16[1],
                       **k1_times(xb, kb, strides, pads, n, plain=plain,
                                  bn=(mul, add, relu)))
            emit(phase="K1 depthwise_conv3d", **row)
            check(err32 <= TOL_F32, f"K1 {where} f32 err {err32}")
            check(rel16 <= TOL_BF16, f"K1 {where} bf16 rel err {rel16}")
            rivals = [row[key] for key in ("generic_ms", "plain_ms",
                                           "library_ms") if key in row]
            check(row["ms"] < min(rivals),
                  f"K1 {where}: the {row['body']} body behind the generic "
                  f"body, the plain version or the library: {row}")
            rows.append(row)
            del xb, kb
            torch.cuda.empty_cache()
        return rows

    k1_serving = {(variant, B): k1_serving_rows(variant, B, cases,
                                                (variant, B) == ("M", CLIPS))
                  for variant, B, cases in k1_paths}
    k1_rows = k1_serving["M", CLIPS]
    for (variant, B), rows in k1_serving.items():
        keys = ("ms", "epilogue_ms", "generic_ms", "library_ms",
                "bound_ms") + (
            ("plain_ms",) if (variant, B) == ("M", CLIPS) else ())
        total = {key: sum(r["n"] * r[key] for r in rows) for key in keys}
        emit(phase="K1 depthwise_conv3d, whole forward", variant=variant,
             clips=B, launches=sum(r["n"] for r in rows), **total,
             **shares(total))

    # ------------------------------------------- 3. K2 vs its plain version
    def sums_err(got, ref, yref):
        scale = yref.abs().sum(dim=(1, 2, 3)).t() if yref is not None \
            else ref.abs()
        return ((got - ref).abs() / scale.clamp_min(1e-30)).max().item()

    k2_lib = _build.load("dw_fused.cu", dw_fused._SIGNATURES)

    def k2_times(xb, a, b, kb, n, plain=True, bn=None):
        """A bfloat16 K2 row's times and bound on these inputs: the kernel
        (the body the wrapper picks), its generic body (what the ring body
        replaced; its C entry point takes every geometry), both launched
        as the wrapper launches them on the same prepared taps, so that
        the two carry the same host work, the body with the BN epilogue
        ``bn`` = (mul, add) as serving launches it, the plain version and
        the library's depthwise conv alone, ``F.conv3d(groups=C)``; with
        the body, the ring body's launch plan and the shares."""
        B, C = xb.shape[0], xb.shape[-1]
        kdims = tuple(kb.shape[:3])
        taps_f32 = kb.float().reshape(-1, C).contiguous()
        stream = torch.cuda.current_stream().cuda_stream

        def body_ms(body):
            return time_ms(lambda: dw_fused._launch_fwd(
                k2_lib, body, xb, a, b, taps_f32, kdims, stream))

        row = dict(n=n, body=dw_fused.segment_body(kdims))
        row.update(ms=body_ms(row["body"]), generic_ms=body_ms("generic"))
        if bn is not None:
            coefs = epilogue.prepare(*bn, xb)
            ep_lib = epilogue.library("dw_fused.cu", dw_fused._SIGNATURES,
                                      coefs)
            row["epilogue"] = epilogue.kind(bn[0], False)
            row["epilogue_ms"] = time_ms(lambda: dw_fused._launch_fwd(
                ep_lib, row["body"], xb, a, b, taps_f32, kdims, stream,
                epilogue.pointers(coefs, False)))
        if row["body"] == "ring":
            row["plan"] = dw_fused._fwd_ring_plan(k2_lib, xb, kdims[0])
        if plain:
            row["plain_ms"] = time_ms(lambda: dw_fused.reference(xb, a, b,
                                                                 kb))
        u = torch.relu(xb.float() * a.t()[:, None, None, None, :]
                       + b.t()[:, None, None, None, :]).bfloat16()
        uc, w = u.permute(0, 4, 1, 2, 3), kb.permute(4, 3, 0, 1, 2)
        pad = tuple(d // 2 for d in kdims)
        row["library_ms"] = time_ms(lambda: F.conv3d(uc, w, padding=pad,
                                                     groups=C))
        row["bound_ms"], row["bound_by"] = bound(*dw_fused.fwd_cost(
            xb.shape, kdims, xb.element_size()))
        row.update(shares(row))
        return row

    def k2_serving_rows(variant, B, kt, cases, plain):
        """K2 against its plain version at one serving batch's shapes,
        float32 and bfloat16, with the bfloat16 times (the plain version's
        where ``plain``)."""
        rows = []
        for name, shape, n in cases:
            C = shape[-1]
            x = randn(*shape)
            a = 0.5 + torch.rand((C, B), generator=gen, device="cuda")
            b = 0.3 * randn(C, B)            # about half the offsets are > 0
            k = randn(kt, 3, 3, 1, C) * 0.3
            where = f"X3D-{variant} {B} clips {name}"
            # bn_b as its epilogue, as serving launches it; the sums stay
            # those of the conv's output
            mul, add = bn_coefs(C)

            def with_bn(x_, k_, y_, p_, s2_, yr_, tol, dtype_name):
                ye, pe, s2e = dw_fused.dw_bn_act_conv(x_, a, b, k_, mul, add)
                differ, err = epilogue_check(
                    f"K2 {where} {dtype_name}", ye, y_, yr_, mul, add,
                    False, tol)
                same = torch.equal(pe, p_) and torch.equal(s2e, s2_)
                check(same, f"K2 {where} {dtype_name}: the sums with the "
                      "epilogue differ from those without")
                return differ + (not same), err

            y, p, s2 = dw_fused.dw_bn_act_conv(x, a, b, k)
            yr, pr, s2r = dw_fused.reference(x, a, b, k)
            torch.cuda.synchronize()
            err32 = (y - yr).abs().max().item()
            errp32, errs32 = sums_err(p, pr, yr), sums_err(s2, s2r, None)
            ep32 = with_bn(x, k, y, p, s2, yr, TOL_F32, "f32")
            xb, kb = x.bfloat16(), k.bfloat16()
            del x, k, y, yr
            yb, pb, s2b = dw_fused.dw_bn_act_conv(xb, a, b, kb)
            yr, pr, s2r = dw_fused.reference(xb.float(), a, b, kb.float())
            rel16 = ((yb.float() - yr).abs().max() / yr.abs().max()).item()
            errp16, errs16 = sums_err(pb, pr, yr), sums_err(s2b, s2r, None)
            ep16 = with_bn(xb, kb, yb, pb, s2b, yr, TOL_BF16, "bf16")
            del yb, pb, s2b, yr, pr, s2r
            row = dict(variant=variant, clips=B, name=name,
                       shape=list(shape), max_abs_err_f32=err32,
                       p_err_f32=errp32, s2_err_f32=errs32,
                       rel_err_bf16=rel16, p_err_bf16=errp16,
                       s2_err_bf16=errs16,
                       epilogue_bits_differ=ep32[0] + ep16[0],
                       epilogue_err_f32=ep32[1], epilogue_err_bf16=ep16[1],
                       **k2_times(xb, a, b, kb, n, plain=plain,
                                  bn=(mul, add)))
            emit(phase="K2 dw_bn_act_conv", **row)
            check(err32 <= TOL_F32, f"K2 {where} f32 y err {err32}")
            check(max(errp32, errs32) <= TOL_F32_SUMS,
                  f"K2 {where} f32 sums err {errp32} {errs32}")
            check(max(rel16, errp16, errs16) <= TOL_BF16,
                  f"K2 {where} bf16 err {rel16} {errp16} {errs16}")
            rows.append(row)
            del xb, kb
            torch.cuda.empty_cache()
        return rows

    k2_serving = {(variant, B): k2_serving_rows(variant, B, kt, cases,
                                                (variant, B) == ("M", CLIPS))
                  for variant, B, kt, cases in k2_paths}
    k2_rows = k2_serving["M", CLIPS]
    for (variant, B), rows in k2_serving.items():
        total = {key: sum(r["n"] * r[key] for r in rows)
                 for key in ("ms", "epilogue_ms", "generic_ms", "library_ms",
                             "bound_ms")}
        emit(phase="K2 dw_bn_act_conv, whole forward", variant=variant,
             clips=B, launches=sum(r["n"] for r in rows), **total,
             **shares(total))

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
    counters = kernel_counters()

    dx_bodies = depthwise.depthwise_conv3d_dx.body_launches
    dk_bodies = depthwise.depthwise_conv3d_dk.body_launches
    k1_bodies = depthwise.depthwise_conv3d.body_launches
    k2_bodies = dw_fused.dw_bn_act_conv.body_launches
    k3_bodies = dw_fused.dw_bn_act_conv_bwd.body_launches
    k7_bodies = pointwise.pw_conv.body_launches
    k8_bodies = depthwise.depthwise_conv3d_pbwd.body_launches


    n_k1 = len(arch.stages) + 1
    n_k2 = sum(len(b) - 1 for b in arch.stages)
    # K7 per forward: every block's convs a and c, the stage entries'
    # projections and conv_5
    n_k7 = 2 * (len(arch.stages) + n_k2) + len(arch.stages) + 1
    torch.cuda.reset_peak_memory_stats()
    outputs = []
    zero_counts()                            # the serving path starts here
    for name, engine, clips in requests:
        before, ep_before = read_counts(), read_epilogues()
        probs = engine.predict(clips)
        after, ep_after = read_counts(), read_epilogues()
        outputs.append((name, probs, {k: after[k] - before[k]
                                      for k in after},
                        {k: {kind: n - ep_before[k][kind]
                             for kind, n in counts.items()}
                         for k, counts in ep_after.items()}))
    serve_launches = read_counts()           # ... and ends here
    serve_k1_bodies = dict(k1_bodies)
    serve_k2_bodies = dict(k2_bodies)
    serve_k7_bodies = dict(k7_bodies)
    # every bfloat16 K7 launch by the body its plan names: the wg body but
    # at K = 54, 108 (rows of 108 and 216 bytes: no tensor map), stage 2's
    # conv a and the strided projections with pixels under 128 bytes, where
    # the pipe body measured faster
    want_k7 = k7_want(cfg, arch, False, len(requests))
    check(serve_k7_bodies == want_k7,
          f"serving K7 bodies {serve_k7_bodies}, want {want_k7}")
    # every K2 of a forward is a fused segment with 3x3 taps: the ring body
    want_k2 = {"ring": len(requests) * n_k2, "generic": 0}
    check(serve_k2_bodies == want_k2,
          f"serving K2 bodies {serve_k2_bodies}, want {want_k2}")
    # K1 of a forward: the stem's k x 1 x 1 conv by the temporal body, the
    # four stride-2 stage entries by the ring body
    want_k1 = {"temporal": len(requests), "ring": len(requests) * (n_k1 - 1),
               "generic": 0}
    check(serve_k1_bodies == want_k1,
          f"serving K1 bodies {serve_k1_bodies}, want {want_k1}")
    # every BatchNorm of a forward as the epilogue of the launch that
    # writes its input: K7 bn_c of every block and bn_r of the projections,
    # bn_a + ReLU at the stage entries and bn_5 + ReLU; K2 bn_b of the
    # fused segments; K1 bn_b at the stage entries and the stem's + ReLU
    n_entries = len(arch.stages)
    want_ep = {"K1": {"bn": n_entries, "bn_relu": 1},
               "K2": {"bn": n_k2, "bn_relu": 0},
               "K7": {"bn": 2 * n_entries + n_k2, "bn_relu": n_entries + 1}}
    for name, probs, d, ep in outputs:
        n_videos = probs.shape[0]
        finite = bool(np.isfinite(probs).all())
        row_err = float(np.abs(probs.sum(-1) - 1.0).max())
        emit(phase="serve", request=name, probs_shape=list(probs.shape),
             finite=finite, max_row_sum_err=row_err, k1_launches=d["K1"],
             k2_launches=d["K2"], k7_launches=d["K7"],
             epilogue_launches=ep)
        check(probs.shape == (n_videos, cfg.NETWORK.NUM_CLASSES) and finite
              and row_err <= TOL_ROW_SUM, f"serve {name} probabilities")
        want = dict.fromkeys(d, 0) | {"K1": n_k1, "K2": n_k2, "K7": n_k7}
        check(d == want, f"serve {name}: launches {d}, want {want}")
        check(ep == want_ep,
              f"serve {name}: epilogue launches {ep}, want {want_ep}")
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

    # ---- 5. K1-K6 at X3D-M's and X3D-S's training shapes, K3-K6's times
    # Every kernel of the training step against its plain version on the
    # same inputs, at the shapes and the batch the step gives it (X3D-M: 32
    # clips; X3D-S: 64 clips of 13 frames, whose 40², 20², 10² and 5²
    # planes are no multiples of the kernels' 8x8 pixel tiles), with
    # per-sample coefficient columns, in float32 and then bfloat16; the
    # bfloat16 inputs are then timed beside the plain versions and the
    # library calls.
    def rel_err(got, ref, scale):
        return ((got.float() - ref.float()).abs()
                / scale.float().clamp_min(1e-30)).max().item()

    def abs_dk(x, g, kdims, strides, pads):
        return depthwise.depthwise_conv3d_dk_reference(
            x.float().abs(), g.float().abs(), kdims, strides, pads)

    dtypes = (torch.float32, torch.bfloat16)      # bfloat16 last: timed

    def training_kernels(variant, vcfg, varch, B):
        """K1-K6 against their plain versions at every shape the training
        step of ``vcfg`` gives them at ``B`` clips, float32 and bfloat16,
        with the bfloat16 times; returns the K1/K2 float32 errors and the
        rows of K4, K2, K3, K5 and K6."""
        T = vcfg.DATA.TEMP_DURATION
        S = vcfg.DATA.TRAIN_CROP_SIZE // 2
        # n: K4 launches per step; the stem's backward runs as K8 where it
        # can (not at X3D-XS: 4 frames, 5 taps), and then its K4 rows stay
        # out of the line's sums
        kt = varch.temp_filter
        stem = ((T, S, S, varch.conv1_dim), (kt, 1, 1), (1, 1, 1),
                ((kt // 2,) * 2, (0, 0), (0, 0)))
        seg_cases, k4_cases = [], [("conv_1.conv_t", *stem, 0 if
                                    depthwise.pbwd_eligible((B, *stem[0]),
                                                            *stem[1:])
                                    else 1)]
        for si, blocks in enumerate(varch.stages):
            k4_cases.append((f"stage{si + 2}_block0.b",
                             (T, S, S, blocks[0].inner_channels),
                             (varch.temp_kernel, 3, 3), (1, 2, 2), "SAME", 1))
            S = -(-S // 2)
            if len(blocks) > 1:
                spec = blocks[1]
                seg_cases.append((f"stage{si + 2} stride-1 blocks", (T, S, S),
                                  spec.out_channels, spec.inner_channels,
                                  len(blocks) - 1))

        def columns(C):
            """Per-sample (C, B) BN coefficient columns: a > 0, about half the
            offsets b > 0."""
            return (0.5 + torch.rand((C, B), generator=gen, device="cuda"),
                    0.3 * randn(C, B))

        train_err = {"K1": 0.0, "K2": 0.0}

        # K1 forward and K4 (dx, dk): the stem's conv_t and the stage entries
        k4_rows = {"dx": [], "dk": []}
        k1_rows_t = []
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
                ry = depthwise.depthwise_conv3d_reference(
                    x.float(), k.float(), strides, pads)
                dx = depthwise.depthwise_conv3d_dx(g, k, x.shape, strides,
                                                   pads)
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
            # K1 runs once a step at every one of these shapes
            row = dict(name=name, shape=[B, *dims], kernel=list(kdims),
                       strides=list(strides), pads=[list(p) for p in pads],
                       max_abs_err_f32=e32[0], rel_err_bf16=e16[1],
                       **k1_times(x, k, strides, pads, 1))
            emit(phase="K1 depthwise_conv3d, training shape",
                 variant=variant, **row)
            k1_rows_t.append(row)
            where = f"X3D-{variant} {name}"
            check(e32[0] <= TOL_F32 and e16[1] <= TOL_BF16,
                  f"K1 {where} training shape err f32 {e32[0]} "
                  f"bf16 {e16[1]}")
            check(row["ms"] < min(row["generic_ms"], row["plain_ms"],
                                  row["library_ms"]),
                  f"K1 {where}: the {row['body']} body behind the generic "
                  f"body, the plain version or the library: {row}")
            check(e32[2] <= TOL_F32 and e32[4] <= TOL_TRAIN_SUMS,
                  f"K4 {where} f32 err dx {e32[2]} dk {e32[4]}")
            check(e16[3] <= TOL_BF16 and e16[4] <= TOL_TRAIN_SUMS,
                  f"K4 {where} bf16 err dx {e16[3]} dk {e16[4]}")
            xc = depthwise._padded_nchw(x, pads).contiguous(
                memory_format=torch.channels_last_3d)
            gc, w = g.permute(0, 4, 1, 2, 3), k.permute(4, 3, 0, 1, 2)

            def cudnn(mask):
                # library yardstick: cuDNN's grouped-conv backward on the
                # channels-last views, the input padded beforehand
                return torch.ops.aten.convolution_backward(
                    gc, xc, w, None, list(strides), [0, 0, 0], [1, 1, 1],
                    False, [0, 0, 0], C, mask)

            # dx and dk alike
            nbytes, ops_ = depthwise.bwd_cost(x.shape, g.shape, kdims,
                                              x.element_size())
            body = depthwise.dx_body(kdims, strides, pads)
            lib = _build.load("depthwise_bwd.cu", depthwise._BWD_SIGNATURES)
            stream = torch.cuda.current_stream().cuda_stream
            extra = {"dx": {"body": body}, "dk": {}}
            if body == "phase":
                # the gather body on the same inputs (its C entry point
                # takes every geometry): what the phase body replaced
                geom = depthwise._bwd_geometry(x.shape, g, kdims, strides,
                                               pads)
                taps_f32 = k.float().reshape(-1, C).contiguous()
                gathered = torch.empty_like(x)

                def gather():
                    rc = lib.x3d_dw_conv3d_dx(
                        g.data_ptr(), taps_f32.data_ptr(),
                        gathered.data_ptr(), 1, *geom,   # bfloat16
                        stream)
                    check(rc == 0, f"K4 dx gather body at {name}: rc {rc}")

                extra["dx"]["gather_ms"] = time_ms(gather)
                del taps_f32, gathered

            def dk_body_ms(dk_body):
                # a dk body launched as the wrapper launches it
                return time_ms(lambda: depthwise._launch_dk(
                    lib, dk_body, x, g, kdims, strides, pads, stream))

            # dk: the body the wrapper picks and the generic body (what the
            # ring body replaced; its C entry point takes every geometry)
            # on the same inputs, through one launcher
            dk_body = depthwise.dk_body(kdims, strides, pads)
            extra["dk"] = {"body": dk_body, "ms": dk_body_ms(dk_body),
                           "generic_ms": dk_body_ms("generic")}
            if dk_body == "ring":
                extra["dk"]["plan"] = depthwise._dk_ring_plan(
                    x, kdims[0], strides[1], out)
            for part, kern, plain, mask, err32, err16 in (
                    ("dx", lambda: depthwise.depthwise_conv3d_dx(
                        g, k, x.shape, strides, pads),
                     lambda: depthwise.depthwise_conv3d_dx_reference(
                         g, k, x.shape, strides, pads),
                     [True, False, False], e32[2], e16[3]),
                    ("dk", None,
                     lambda: depthwise.depthwise_conv3d_dk_reference(
                         x, g, kdims, strides, pads),
                     [False, True, False], e32[4], e16[4])):
                bms, by = bound(nbytes, ops_)
                row = dict(name=name, shape=[B, *dims], kernel=list(kdims),
                           strides=list(strides), pads=[list(p) for p in pads],
                           n=n, max_abs_err_f32=err32, err_bf16=err16,
                           plain_ms=time_ms(plain),
                           library_ms=time_ms(lambda: cudnn(mask)),
                           bound_ms=bms, bound_by=by, **extra[part])
                if kern is not None:
                    row["ms"] = time_ms(kern)
                row.update(shares(row))
                emit(phase=f"K4 depthwise_conv3d_{part}", variant=variant,
                     **row)
                k4_rows[part].append(row)
            row = k4_rows["dk"][-1]
            check(row["body"] != "ring" or row["ms"] < min(
                row["generic_ms"], row["plain_ms"], row["library_ms"]),
                f"K4 dk {where}: the ring body behind the generic body, "
                f"the plain version or cuDNN: {row}")
            del x, g, k, xc, gc, w
            torch.cuda.empty_cache()

        # K2 forward, K3, K5 and K6 at each stage's stride-1 blocks
        k2_rows, k3_rows, k5_rows, k6_rows = [], [], [], []
        for name, thw, cout_blk, C, n in seg_cases:
            kdims = (varch.temp_kernel, 3, 3)
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
                # K5: the block's conv a; K6: its conv c on the segment's
                # output
                xa = randn(B, *thw, cout_blk).to(dtype)
                wa, wc = 0.2 * randn(C, cout_blk), 0.2 * randn(cout_blk, C)
                e56 = []
                for fn, ref, args, absargs in (
                        (pw_stats.pw_conv_stats,
                         pw_stats.pw_conv_stats_reference, (xa, wa),
                         (xa.float().abs(), wa.abs())),
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
            row = dict(name=name, shape=[B, *thw, C], max_abs_err_f32=e32[0],
                       sums_err_f32=e32[2], rel_err_bf16=e16[1],
                       sums_err_bf16=e16[2], **k2_times(x, a, b, k, n))
            emit(phase="K2 dw_bn_act_conv, training shape", variant=variant,
                 **row)
            k2_rows.append(row)
            where = f"X3D-{variant} {name}"
            check(e32[0] <= TOL_F32 and e32[2] <= TOL_F32_SUMS,
                  f"K2 {where} training shape f32 err {e32}")
            check(max(e16[1], e16[2]) <= TOL_BF16,
                  f"K2 {where} training shape bf16 err {e16}")
            for i, kname in enumerate(("K3", "K5", "K6"), start=1):
                e32, e16 = errs[torch.float32][i], errs[torch.bfloat16][i]
                check(e32[0] <= TOL_F32 and e32[2] <= TOL_TRAIN_SUMS,
                      f"{kname} {where} f32 err {e32}")
                check(e16[1] <= TOL_BF16 and e16[2] <= TOL_TRAIN_SUMS,
                      f"{kname} {where} bf16 err {e16}")

            u = torch.relu(x.float() * a.t()[:, None, None, None, :]
                           + b.t()[:, None, None, None, :]).bfloat16()
            uc, gc = u.permute(0, 4, 1, 2, 3), gy.permute(0, 4, 1, 2, 3)
            w = k.permute(4, 3, 0, 1, 2)
            bms, by = bound(*dw_fused.bwd_cost(x.shape, kdims,
                                               x.element_size()))
            e32, e16 = errs[torch.float32][1], errs[torch.bfloat16][1]
            row = dict(
                name=name, shape=[B, *thw, C], n=n, max_abs_err_f32=e32[0],
                sums_err_f32=e32[2], err_bf16=e16[1], sums_err_bf16=e16[2],
                ms=time_ms(lambda: dw_fused.dw_bn_act_conv_bwd(
                    x, a, b, k, y, gy, gp, gs2)),
                plain_ms=time_ms(lambda: dw_fused.bwd_reference(
                    x, a, b, k, y, gy, gp, gs2)),
                # library yardstick: cuDNN's grouped-conv backward (dx and
                # dk) of the depthwise conv alone, on u and the cotangent
                library_ms=time_ms(
                    lambda: torch.ops.aten.convolution_backward(
                        gc, uc, w, None, [1, 1, 1], [1, 1, 1], [1, 1, 1],
                        False, [0, 0, 0], C, [True, True, False])),
                bound_ms=bms, bound_by=by,
                body=dw_fused.segment_body(kdims))
            if row["body"] == "ring":
                # the generic body on the same inputs (its C entry point
                # takes every geometry): what the ring body replaced
                lib = _build.load("dw_fused_bwd.cu",
                                  dw_fused._BWD_SIGNATURES)
                row["plan"] = dw_fused._ring_plan(lib, x, y, gy, kdims[0])
                cols = [t.float().contiguous() for t in (a, b, gp, gs2)]
                taps_f32 = k.float().reshape(-1, C).contiguous()
                stream = torch.cuda.current_stream().cuda_stream
                row["generic_ms"] = time_ms(lambda: dw_fused._launch_bwd(
                    lib, "generic", x, cols, taps_f32, y, gy, kdims, stream))
                del cols, taps_f32
            row.update(shares(row))
            emit(phase="K3 dw_bn_act_conv_bwd", variant=variant, **row)
            k3_rows.append(row)
            del gy, u, uc, gc
            for kname, fn, ref, args, mm_in, w_, rows, i in (
                    ("K5 pw_conv_stats", pw_stats.pw_conv_stats,
                     pw_stats.pw_conv_stats_reference, (xa, wa), xa, wa,
                     k5_rows, 2),
                    ("K6 pw_act_conv_stats", pw_stats.pw_act_conv_stats,
                     pw_stats.pw_act_conv_stats_reference, (y, a, b, wc), y,
                     wc, k6_rows, 3)):
                K, N = w_.shape[1], w_.shape[0]
                M = mm_in.numel() // K
                wb = w_.bfloat16()

                def library():
                    # yardstick: torch.matmul, then the per-sample sum pass
                    z = torch.matmul(mm_in, wb.t()).float()
                    return z.sum(dim=(1, 2, 3)), (z * z).sum(dim=(1, 2, 3))

                cost = pw_stats.act_conv_stats_cost \
                    if fn is pw_stats.pw_act_conv_stats \
                    else pw_stats.conv_stats_cost
                bms, by = bound(*cost(M, K, N, B, 2), BF16_TC_FLOP_PER_S)
                e32, e16 = errs[torch.float32][i], errs[torch.bfloat16][i]
                row = dict(name=name, shape=[B, *thw, K], cout=N, n=n,
                           max_abs_err_f32=e32[0], sums_err_f32=e32[2],
                           err_bf16=e16[1], sums_err_bf16=e16[2],
                           ms=time_ms(lambda: fn(*args)),
                           plain_ms=time_ms(lambda: ref(*args)),
                           library_ms=time_ms(library), bound_ms=bms,
                           bound_by=by,
                           plan=pw_stats.plan(K, N, fn is
                                              pw_stats.pw_act_conv_stats))
                row.update(shares(row))
                emit(phase=kname, variant=variant, **row)
                rows.append(row)
            del x, y, xa
            torch.cuda.empty_cache()
        return (train_err, k1_rows_t, k4_rows, k2_rows, k3_rows, k5_rows,
                k6_rows)

    (train_err, k1_train, k4_rows, k2_train, k3_rows, k5_rows,
     k6_rows) = training_kernels("M", cfg, arch, TRAIN_CLIPS)
    (train_err_s, k1_train_s, k4_rows_s, k2_train_s, k3_rows_s, k5_rows_s,
     k6_rows_s) = training_kernels("S", cfg_s, arch_s, S_TRAIN_CLIPS)

    # ----------------------------------------------- 6. X3D-M training
    model = create_model(cfg, dtype=torch.bfloat16, seed=SEED)
    state = create_train_state(cfg, model)
    train_step = make_train_step(model, cfg.NETWORK.WEIGHT_DECAY)
    batch = next(synthetic_batches(cfg, TRAIN_CLIPS, seed=SEED))
    dropout_gen = torch.Generator(device="cuda").manual_seed(SEED)
    # per step: K4 at the four stage entries and K8 at the stem; K7 at the
    # stage entries' convs a and c, the projections and conv_5, forward and
    # dx; K5/K6 take the stride-1 blocks' pointwise convs
    n_k7_step = 2 * (3 * len(arch.stages) + 1)
    want_step = {"K1": n_k1, "K2": n_k2, "K3": n_k2, "K4 dx": n_k1 - 1,
                 "K4 dk": n_k1 - 1, "K5": n_k2, "K6": n_k2,
                 "K7": n_k7_step, "K8": 1, "K9": 0}
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
    train_dx_bodies = dict(dx_bodies)
    train_dk_bodies = dict(dk_bodies)
    train_k1_bodies = dict(k1_bodies)
    train_k2_bodies = dict(k2_bodies)
    train_k3_bodies = dict(k3_bodies)
    train_k7_bodies = dict(k7_bodies)
    train_k8_bodies = dict(k8_bodies)
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
         launches_per_step=want_step, k1_bodies=train_k1_bodies,
         k4_dx_bodies=train_dx_bodies, k4_dk_bodies=train_dk_bodies,
         k2_bodies=train_k2_bodies,
         k3_bodies=train_k3_bodies, k7_bodies=train_k7_bodies,
         k8_bodies=train_k8_bodies)
    want = k7_want(cfg, arch, True, TRAIN_STEPS)
    check(train_k7_bodies == want,
          f"K7 bodies {train_k7_bodies}, want {want}")
    # every K4 dx of the step is a stride-2 stage entry: the phase body
    want_bodies = {"phase": TRAIN_STEPS * want_step["K4 dx"], "gather": 0}
    check(train_dx_bodies == want_bodies,
          f"K4 dx bodies {train_dx_bodies}, want {want_bodies}")
    want = {"temporal": TRAIN_STEPS, "ring": TRAIN_STEPS * (n_k1 - 1),
            "generic": 0}
    check(train_k1_bodies == want,
          f"K1 bodies {train_k1_bodies}, want {want}")
    # every K4 dk of the step is a stride-2 stage entry, and every K2 and
    # K3 a fused segment with 3x3 taps: the ring bodies
    for kname, got in (("K4 dk", train_dk_bodies), ("K2", train_k2_bodies),
                       ("K3", train_k3_bodies)):
        want = {"ring": TRAIN_STEPS * want_step[kname], "generic": 0}
        check(got == want, f"{kname} bodies {got}, want {want}")
    # the step's one K8, the stem's 5x1x1 conv_t: the temporal body
    want = {"temporal": TRAIN_STEPS * want_step["K8"], "generic": 0}
    check(train_k8_bodies == want,
          f"K8 bodies {train_k8_bodies}, want {want}")

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

    f32_step_check(emit, check, cfg, "M", want_step)

    # ------------------------------ 7. K7 vs its plain version and F.linear
    k7_cases = profile_pointwise.cases
    k7_lib = _build.load("pointwise.cu", pointwise._SIGNATURES)
    k7_stream = torch.cuda.current_stream().cuda_stream

    def k7_epilogue(name):
        """The BN epilogue a serving forward gives K7's case ``name``:
        None for the stride-1 blocks' conv a (K2 takes their BatchNorm),
        True (with the ReLU) for conv a at the stage entries and conv_5,
        False for conv c and the projections."""
        if name.endswith("blocks' a"):
            return None
        return name.endswith("block0.a") or name == "conv_5"

    def k7_rows(variant, path, vcfg, varch, B, crop, train):
        rows = []
        for name, shape, N, strides, n in k7_cases(vcfg, varch, B, crop,
                                                    train):
            K = shape[-1]
            errs = {}
            # serving: the BatchNorm after the conv as its epilogue
            relu = None if train else k7_epilogue(name)
            bn = None if relu is None else bn_coefs(N)
            ep = {}
            for dtype in dtypes:
                x = randn(*shape).to(dtype)
                w = (randn(N, K) / math.sqrt(K)).to(dtype)
                y = pointwise.pw_conv(x, w, strides)
                g = randn(*y.shape).to(dtype)
                dx = pointwise.pw_conv(g, w.t())
                ry = pointwise.pointwise_conv3d_reference(
                    x.float(), w.float(), strides)
                rdx = torch.matmul(g.float(), w.float())
                torch.cuda.synchronize()
                errs[dtype] = (max((y.float() - ry).abs().max().item(),
                                   (dx.float() - rdx).abs().max().item()),
                               max(rel_err(y, ry, ry.abs().max()),
                                   rel_err(dx, rdx, rdx.abs().max())))
                if bn is not None:
                    f32 = dtype == torch.float32
                    ep[dtype] = epilogue_check(
                        f"K7 X3D-{variant} {path} {name} "
                        f"{'f32' if f32 else 'bf16'}",
                        pointwise.pw_conv(x, w, strides, "fwd", *bn, relu),
                        y, ry, *bn, relu, TOL_F32 if f32 else TOL_BF16)
                del ry, rdx
                if dtype == torch.float32:
                    del x, w, y, g, dx
            e32, e16 = errs[torch.float32], errs[torch.bfloat16]
            where = f"X3D-{variant} {path} {name}"
            check(e32[1] <= TOL_K7_F32, f"K7 {where} f32 rel err {e32[1]}")
            check(e16[1] <= TOL_K7_BF16, f"K7 {where} bf16 rel err {e16[1]}")
            xs = pointwise._subsample(x, strides).contiguous()
            wt = w.t().contiguous()
            # the generic body (pipe_gemm) on the same inputs
            gen_fwd = time_ms(lambda: pointwise._launch(
                k7_lib, "pipe", x, w, strides, k7_stream))
            gen_dx = time_ms(lambda: pointwise._launch(
                k7_lib, "pipe", g, wt, (1, 1, 1), k7_stream))
            M = y.numel() // N
            bms, by = bound(*pointwise.cost(M, K, N, 2), BF16_TC_FLOP_PER_S)
            fwd = time_ms(lambda: pointwise.pw_conv(x, w, strides))
            bwd = time_ms(lambda: pointwise.pw_conv(g, w.t()))
            plain = time_ms(lambda: pointwise.pointwise_conv3d_reference(
                x, w, strides))
            # library yardstick: F.linear on the rows the conv reads (the
            # subsample of a strided projection made beforehand), and
            # torch.matmul for dx
            lib_fwd = time_ms(lambda: F.linear(xs, w))
            lib_bwd = time_ms(lambda: torch.matmul(g, w))
            both = 2 if train else 1           # forward, and dx in a step
            row = dict(name=name, shape=list(shape), cout=N,
                       strides=list(strides), n=n,
                       max_abs_err_f32=e32[0], rel_err_f32=e32[1],
                       rel_err_bf16=e16[1], fwd_ms=fwd, dx_ms=bwd,
                       library_fwd_ms=lib_fwd, library_dx_ms=lib_bwd,
                       ms=fwd + bwd if train else fwd,
                       plain_ms=plain + lib_bwd if train else plain,
                       library_ms=lib_fwd + lib_bwd if train else lib_fwd,
                       generic_ms=gen_fwd + gen_dx if train else gen_fwd,
                       bound_ms=both * bms, bound_by=by,
                       plan=pointwise.plan(shape, N, strides))
            if train:
                row["plan_dx"] = pointwise.plan(y.shape, K)
            if bn is not None:
                e32, e16 = ep[torch.float32], ep[torch.bfloat16]
                row.update(
                    epilogue=epilogue.kind(bn[0], relu),
                    epilogue_ms=time_ms(lambda: pointwise.pw_conv(
                        x, w, strides, "fwd", *bn, relu)),
                    epilogue_bits_differ=e32[0] + e16[0],
                    epilogue_err_f32=e32[1], epilogue_err_bf16=e16[1])
            row.update(shares(row))
            emit(phase="K7 pw_conv", variant=variant, path=path, **row)
            rows.append(row)
            del x, w, y, g, dx, xs, wt
            torch.cuda.empty_cache()
        return rows

    k7 = {}
    for variant, vcfg, varch, train_clips in (
            ("M", cfg, arch, TRAIN_CLIPS), ("S", cfg_s, arch_s, S_TRAIN_CLIPS)):
        for clips in (CLIPS, S_EVAL_CLIPS):      # requests of 1 and 8 videos
            k7[variant, f"serving, {clips} clips"] = k7_rows(
                variant, f"serving, {clips} clips", vcfg, varch, clips,
                vcfg.DATA.TEST_CROP_SIZE, False)
        k7[variant, "training"] = k7_rows(
            variant, "training", vcfg, varch, train_clips,
            vcfg.DATA.TRAIN_CROP_SIZE, True)
    for (variant, path), rows in k7.items():
        total = {key: sum(r["n"] * r[key] for r in rows)
                 for key in ("ms", "library_ms", "bound_ms", "generic_ms")}
        # the calls with an epilogue, with it and without
        fused = [r for r in rows if "epilogue" in r]
        emit(phase="K7 pw_conv, whole path", variant=variant, path=path,
             launches=sum(r["n"] for r in rows) * (2 if path == "training"
                                                   else 1),
             **total, **shares(total),
             epilogue_launches=sum(r["n"] for r in fused),
             epilogue_ms=sum(r["n"] * r["epilogue_ms"] for r in fused),
             epilogue_without_ms=sum(r["n"] * r["ms"] for r in fused))

    # device time per case (tools/profile_pointwise): K7 as the model calls
    # it, each tensor-core body that takes the call and F.linear on the same
    # inputs; a case fails where the wg body is behind the pipe body by
    # more than device time's spread between runs (3%)
    for variant, vcfg, varch, train_clips in (
            ("M", cfg, arch, TRAIN_CLIPS), ("S", cfg_s, arch_s, S_TRAIN_CLIPS)):
        for path, clips, train in (
                (f"serving, {CLIPS} clips", CLIPS, False),
                (f"serving, {S_EVAL_CLIPS} clips", S_EVAL_CLIPS, False),
                ("training", train_clips, True)):
            crop = vcfg.DATA.TRAIN_CROP_SIZE if train \
                else vcfg.DATA.TEST_CROP_SIZE
            found = k7_cases(vcfg, varch, clips, crop, train)
            rows = []
            for name, shape, N, strides, n in (
                    profile_pointwise.with_dx(found) if train else found):
                row = {"case": name, "n": n,
                       **profile_pointwise.case_row(shape, N, strides)}
                emit(phase="K7 pw_conv, device time per case",
                     variant=variant, path=path, clips=clips, **row)
                rows.append(row)
                if row["body"] == "wg":
                    check(row["wg_us"] <= 1.03 * row["pipe_us"],
                          f"K7 X3D-{variant} {path} {name}: wg body "
                          f"{row['wg_us']} us behind the pipe body "
                          f"{row['pipe_us']} us")
            total = {key: sum(r["n"] * r.get(key, r["k7_us"]) for r in rows)
                     for key in ("k7_us", "pipe_us", "library_us",
                                 "bound_us")}
            emit(phase="K7 pw_conv, device time per path", variant=variant,
                 path=path, clips=clips, launches=sum(r["n"] for r in rows),
                 **total, bound_share=total["bound_us"] / total["k7_us"],
                 vs_library=total["k7_us"] / total["library_us"],
                 vs_generic=total["k7_us"] / total["pipe_us"],
                 lost_windows=trace.lost,
                 rows_by_events=sum(r["timer"] == "events" for r in rows))

    # the host's time to launch K7 (tensor maps encoded per call for the wg
    # body) at X3D-M's stage-5 conv c, each body through _launch and K7 as
    # the model calls it; enqueued back to back, one synchronise at the end
    x5 = randn(CLIPS, 16, 7, 7, 432).bfloat16()
    w5 = (randn(192, 432) / math.sqrt(432)).bfloat16()
    host_us = {}
    for label, fn in (
            ("pw_conv", lambda: pointwise.pw_conv(x5, w5)),
            ("wg", lambda: pointwise._launch(k7_lib, "wg", x5, w5, (1, 1, 1),
                                             k7_stream)),
            ("pipe", lambda: pointwise._launch(k7_lib, "pipe", x5, w5,
                                               (1, 1, 1), k7_stream))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        host_us[label] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    emit(phase="K7 pw_conv, host time per launch", case="stage5 c, 10 clips",
         host_us=host_us)
    del x5, w5

    # K7's and F.linear's device time (torch.profiler, as the profile tools
    # take it) over the bulk 1x1x1 convs of one X3D-M 10-clip forward, each
    # case as often as the forward runs it, in bfloat16; F.linear on the
    # rows a strided conv reads, subsampled beforehand, as in the rows above
    calls = []
    for _, shape, N, strides, n in k7_cases(cfg, arch, CLIPS,
                                             cfg.DATA.TEST_CROP_SIZE, False):
        x = randn(*shape).bfloat16()
        w = (randn(N, shape[-1]) / math.sqrt(shape[-1])).bfloat16()
        calls.append((x, w, strides, pointwise._subsample(x, strides)
                      .contiguous(), n))

    def k7_forward():
        for x, w, strides, _, n in calls:
            for _ in range(n):
                pointwise.pw_conv(x, w, strides)

    def linear_forward():
        for _, w, _, xs, n in calls:
            for _ in range(n):
                F.linear(xs, w)

    dev, n_calls = {}, sum(c[-1] for c in calls)
    # a window is complete with a kernel for every call (tools/trace)
    for label, fn, complete in (
            ("k7", k7_forward, lambda got: got["group_kernels_per_forward"]
             .get("K7", 0) >= n_calls),
            ("library", linear_forward,
             lambda got: got["kernels_per_forward"] >= n_calls)):
        got = trace(fn, 5, "forward", group=lambda name: "K7"
                    if "pw_conv" in name else family(name), complete=complete)
        dev[label] = {"busy_ms": got["device_busy_ms_per_forward"],
                      "by_group_ms": got["group_ms_per_forward"],
                      "kernels": got["kernels_per_forward"]}
    emit(phase="K7 pw_conv, device time", variant="M",
         path=f"serving, {CLIPS} clips", launches=sum(c[-1] for c in calls),
         k7_ms=dev["k7"]["by_group_ms"].get("K7", 0.0),
         k7_busy_ms=dev["k7"]["busy_ms"],
         library_busy_ms=dev["library"]["busy_ms"], detail=dev)
    check(sum(c[-1] for c in calls) == n_k7,
          f"K7 device-time cases: {sum(c[-1] for c in calls)} launches, "
          f"want {n_k7}")
    del calls
    torch.cuda.empty_cache()
    # K1, K2, K5 and K6 over one training step of each variant, against
    # the library's depthwise conv (K1, K2) or matmul + sums (K5, K6)
    for variant, rows1, rows2, rows5, rows6 in (
            ("M", k1_train, k2_train, k5_rows, k6_rows),
            ("S", k1_train_s, k2_train_s, k5_rows_s, k6_rows_s)):
        for kname, rows in (("K1", rows1), ("K2", rows2), ("K5", rows5),
                            ("K6", rows6)):
            total = {key: sum(r["n"] * r[key] for r in rows)
                     for key in ("ms", "plain_ms", "library_ms", "bound_ms")
                     + (("generic_ms",) if kname in ("K1", "K2") else ())}
            emit(phase=f"{kname}, whole training step", variant=variant,
                 launches=sum(r["n"] for r in rows), **total,
                 **shares(total))

    # ------------------------- 8. K8 vs its plain version and vs K4 dx + dk
    k8_lib = _build.load("depthwise_pbwd.cu", depthwise._PBWD_SIGNATURES)

    def k8_row(name, shape, kdims):
        C = shape[-1]
        pads = depthwise._resolve_pads(shape, kdims, (1, 1, 1), "SAME")
        one = (1, 1, 1)
        errs = {}
        for dtype in dtypes:
            u, gy = randn(*shape).to(dtype), randn(*shape).to(dtype)
            k = (randn(*kdims, 1, C) * 0.3).to(dtype)
            du, dk = depthwise.depthwise_conv3d_pbwd(u, gy, k)
            rdu, rdk = depthwise.depthwise_conv3d_pbwd_reference(
                u.float(), gy.float(), k.float())
            dx4 = depthwise.depthwise_conv3d_dx(gy, k, u.shape, one, pads)
            dk4 = depthwise.depthwise_conv3d_dk(u, gy, kdims, one, pads)
            scale = abs_dk(u, gy, kdims, one, pads)
            torch.cuda.synchronize()
            errs[dtype] = ((du.float() - rdu).abs().max().item(),
                           rel_err(du, rdu, rdu.abs().max()),
                           rel_err(dk, rdk, scale),
                           rel_err(du, dx4, rdu.abs().max()),
                           rel_err(dk, dk4, scale))
            del du, dk, rdu, rdk, dx4, dk4, scale
        e32, e16 = errs[torch.float32], errs[torch.bfloat16]
        check(e32[0] <= TOL_F32 and e32[2] <= TOL_TRAIN_SUMS,
              f"K8 {name} f32 err du {e32[0]} dk {e32[2]}")
        check(e16[1] <= TOL_BF16 and e16[2] <= TOL_TRAIN_SUMS,
              f"K8 {name} bf16 err du {e16[1]} dk {e16[2]}")
        check(e32[3] <= TOL_K7_F32 and e16[3] <= TOL_K7_BF16
              and max(e32[4], e16[4]) <= TOL_K8_VS_K4_DK,
              f"K8 {name} vs K4: du f32 {e32[3]} bf16 {e16[3]}, "
              f"dk f32 {e32[4]} bf16 {e16[4]}")
        uc = depthwise._padded_nchw(u, pads).contiguous(
            memory_format=torch.channels_last_3d)
        gc, w = gy.permute(0, 4, 1, 2, 3), k.permute(4, 3, 0, 1, 2)
        taps = math.prod(kdims)
        body = depthwise.pbwd_body(kdims, pads)
        plan = {}
        # a temporal-body run cut along T rereads kt - 1 frames of u and gy
        reread = 0
        if body == "temporal":
            plan = depthwise._pbwd_temporal_plan(k8_lib, u, gy, u, kdims[0])
            reread = (plan["runs"] - 1) * (kdims[0] - 1) * 2 * \
                u[:, 0].numel()
        nbytes, flops = depthwise.pbwd_cost(u.shape, kdims, u.element_size())
        bms, by = bound(nbytes + reread * u.element_size(), flops)
        taps_f32 = k.float().reshape(taps, C).contiguous()
        stream = torch.cuda.current_stream().cuda_stream
        row = dict(
            name=name, shape=list(shape), kernel=list(kdims), n=1,
            body=body, plan=plan,
            max_abs_err_f32=e32[0], dk_err_f32=e32[2], err_bf16=e16[1],
            dk_err_bf16=e16[2], du_vs_k4_f32=e32[3], du_vs_k4_bf16=e16[3],
            dk_vs_k4_f32=e32[4], dk_vs_k4_bf16=e16[4],
            ms=time_ms(lambda: depthwise.depthwise_conv3d_pbwd(u, gy, k)),
            # the generic body, which took every call before the temporal
            # body existed, on the same inputs
            generic_ms=time_ms(lambda: depthwise._launch_pbwd(
                k8_lib, "generic", u, gy, taps_f32, kdims, stream)),
            plain_ms=time_ms(
                lambda: depthwise.depthwise_conv3d_pbwd_reference(u, gy, k)),
            k4_dx_ms=time_ms(lambda: depthwise.depthwise_conv3d_dx(
                gy, k, u.shape, one, pads)),
            k4_dk_ms=time_ms(lambda: depthwise.depthwise_conv3d_dk(
                u, gy, kdims, one, pads)),
            # library yardstick: cuDNN's grouped-conv backward (dx and dk)
            # on the channels-last views, the input padded beforehand
            library_ms=time_ms(lambda: torch.ops.aten.convolution_backward(
                gc, uc, w, None, [1, 1, 1], [0, 0, 0], [1, 1, 1], False,
                [0, 0, 0], C, [True, True, False])),
            bound_ms=bms, bound_by=by)
        emit(phase="K8 depthwise_conv3d_pbwd", **row)
        if body == "temporal":
            check(row["ms"] < min(row["generic_ms"], row["plain_ms"],
                                  row["library_ms"]),
                  f"K8 {name}: the temporal body ({row['ms']} ms) is behind "
                  f"the generic body ({row['generic_ms']}), the plain "
                  f"version ({row['plain_ms']}) or cuDNN "
                  f"({row['library_ms']})")
        del u, gy, k, uc, gc, w, taps_f32
        torch.cuda.empty_cache()
        return row

    def stem_shape(vcfg, varch, B):
        S = vcfg.DATA.TRAIN_CROP_SIZE // 2
        return (B, vcfg.DATA.TEMP_DURATION, S, S, varch.conv1_dim)

    stem_taps = (arch.temp_filter, 1, 1)
    k8_m = k8_row("X3D-M conv_1.conv_t", stem_shape(cfg, arch, TRAIN_CLIPS),
                  stem_taps)
    k8_s = k8_row("X3D-S conv_1.conv_t",
                  stem_shape(cfg_s, arch_s, S_TRAIN_CLIPS), stem_taps)
    S2 = cfg_s.DATA.TRAIN_CROP_SIZE // 4
    k8_row("X3D-S stage 2, 3x3x3",
           (S_TRAIN_CLIPS, cfg_s.DATA.TEMP_DURATION, S2, S2,
            arch_s.stages[0][0].inner_channels), (arch_s.temp_kernel, 3, 3))

    # ----------------------- 9. K9 vs its plain version, and the probe tool
    k9_err = {}
    for dtype, tol in ((torch.float32, TOL_K9_F32),
                       (torch.bfloat16, TOL_K9_BF16)):
        x = torch.rand(1 << 16, generator=gen, device="cuda").to(dtype)
        got = fma_probe.fma_chain(x, unroll=8, inner=4)
        want = fma_probe.fma_chain_reference(x, unroll=8, inner=4)
        k9_err[dtype] = (got.float() - want.float()).abs().max().item()
        check(k9_err[dtype] <= tol, f"K9 {dtype} chain err {k9_err[dtype]}")
    zero_counts()                               # the probe's path starts here
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fma_probe.main([])
    probe_launches = read_counts()              # ... and ends here
    probe = json.loads(out.getvalue().strip().splitlines()[-1])
    n_probe = 16 * 1024 * 1024 // 4             # the tool's float32 block
    x = torch.full((n_probe,), 0.5, device="cuda")
    k9_ms = time_ms(lambda: fma_probe.fma_chain(x))
    k9_plain_ms = time_ms(lambda: fma_probe.fma_chain_reference(x), iters=2)
    k9_bound, k9_by = bound(2 * x.numel() * 4, 2 * 8 * 64 * x.numel())
    del x
    emit(phase="K9 fma_chain", chain_err_f32=k9_err[torch.float32],
         chain_err_bf16=k9_err[torch.bfloat16], ms=k9_ms,
         plain_ms=k9_plain_ms, bound_ms=k9_bound, bound_by=k9_by,
         launches=probe_launches["K9"], probe=probe)
    check(0 < probe["f32_share_of_peak"] <= 1.0
          and 0 < probe["bf16_share_of_packed_peak"] <= 1.0,
          f"K9 probe shares of the peak: {probe}")
    check(probe_launches["K9"] > 0, "the probe tool launched no K9")

    # ---------- 10. X3D-S through the command-line tools: train, resume,
    # ---------- evaluate, serve from the checkpoint
    class Keep:
        """A hook that keeps the live state, every fetched loss and an
        event at the end of each step."""

        def __init__(self):
            self.state, self.losses, self.events = None, {}, []
            self.first_step = None

        def on_epoch_start(self, epoch, lr): ...

        def on_step(self, step, metrics):
            self.losses[step] = metrics["loss"]

        def on_step_end(self, step, state):
            if self.first_step is None:
                self.first_step = step
            self.state = state
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.events.append(event)

        def on_epoch_end(self, *args): ...
        def on_train_end(self): ...

    class LogLines(logging.Handler):
        def __init__(self):
            super().__init__()
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    s_config = "x3d_tpu_torch/configs/kinetics/X3D_S.yaml"

    def run_train(model_dir, epochs, cadence):
        keep, lines = Keep(), LogLines()
        logging.getLogger("x3d_tpu_torch").addHandler(lines)
        try:
            rc = train_cli.main(
                [f"--config={s_config}", "--synthetic",
                 f"--model_dir={model_dir}", "--steps_per_epoch=3",
                 f"--epochs={epochs}", f"--save_checkpoints_step={cadence}"],
                extra_hooks=[keep])
        finally:
            logging.getLogger("x3d_tpu_torch").removeHandler(lines)
        check(rc == 0, f"train CLI returned {rc}")
        torch.cuda.synchronize()
        return keep, lines.lines

    def run_cli(main, argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = main(argv)
        check(rc == 0, f"{main.__module__} returned {rc}")
        return [json.loads(ln) for ln in out.getvalue().splitlines()
                if ln.startswith("{")]

    n_k1_s = len(arch_s.stages) + 1
    n_k2_s = sum(len(b) - 1 for b in arch_s.stages)
    want_s_step = {"K1": n_k1_s, "K2": n_k2_s, "K3": n_k2_s,
                   "K4 dx": n_k1_s - 1, "K4 dk": n_k1_s - 1, "K5": n_k2_s,
                   "K6": n_k2_s, "K7": 2 * (3 * len(arch_s.stages) + 1),
                   "K8": 1, "K9": 0}
    want_s_forward = dict.fromkeys(want_s_step, 0) | {
        "K1": n_k1_s, "K2": n_k2_s,
        "K7": 2 * (len(arch_s.stages) + n_k2_s) + len(arch_s.stages) + 1}
    # cuDNN's flags stay as phase 6 left them (PyTorch's defaults): the
    # tools make their runs deterministic themselves (setup_runtime)
    with tempfile.TemporaryDirectory() as run_dir, \
            tempfile.TemporaryDirectory() as straight_dir:
        torch.cuda.reset_peak_memory_stats()
        zero_counts()                       # the X3D-S path starts here
        first, _ = run_train(run_dir, epochs=2, cadence=2)
        s_train_launches = read_counts()    # (its training part ends here)
        s_k1_bodies = dict(k1_bodies)
        s_dk_bodies = dict(dk_bodies)
        s_k2_bodies = dict(k2_bodies)
        s_k3_bodies = dict(k3_bodies)
        s_k7_bodies = dict(k7_bodies)
        s_k8_bodies = dict(k8_bodies)
        s_peak = torch.cuda.max_memory_allocated()
        saved = CheckpointManager(f"{run_dir}/checkpoints").keys()
        emit(phase="X3D-S train CLI", clips=S_TRAIN_CLIPS, epochs=2,
             steps_per_epoch=3, losses=first.losses, checkpoints=saved,
             launches=s_train_launches, launches_per_step=want_s_step,
             k1_bodies=s_k1_bodies, k4_dk_bodies=s_dk_bodies,
             k2_bodies=s_k2_bodies,
             k3_bodies=s_k3_bodies, k7_bodies=s_k7_bodies,
             k8_bodies=s_k8_bodies,
             # from one step's end to the next, hooks and saves included
             step_interval_ms=[a.elapsed_time(b) for a, b in
                               zip(first.events, first.events[1:])],
             peak_memory_bytes=s_peak)
        check(saved == [2, 3, 4, 6], f"X3D-S checkpoints {saved}")
        check(first.state is not None and first.state.step == 6
              and sorted(first.losses) == [2, 3, 4, 6]
              and all(math.isfinite(v) for v in first.losses.values()),
              f"X3D-S train: losses {first.losses}")
        check(s_train_launches == {k: 6 * v for k, v in want_s_step.items()},
              f"X3D-S train launches {s_train_launches}, want 6 x "
              f"{want_s_step}")
        for kname, got in (("K4 dk", s_dk_bodies), ("K2", s_k2_bodies),
                           ("K3", s_k3_bodies)):
            want = {"ring": 6 * want_s_step[kname], "generic": 0}
            check(got == want, f"X3D-S {kname} bodies {got}, want {want}")
        want = {"temporal": 6, "ring": 6 * (n_k1_s - 1), "generic": 0}
        check(s_k1_bodies == want,
              f"X3D-S K1 bodies {s_k1_bodies}, want {want}")
        want = k7_want(cfg_s, arch_s, True, 6)
        check(s_k7_bodies == want,
              f"X3D-S K7 bodies {s_k7_bodies}, want {want}")
        want = {"temporal": 6 * want_s_step["K8"], "generic": 0}
        check(s_k8_bodies == want,
              f"X3D-S K8 bodies {s_k8_bodies}, want {want}")

        # the same command with one more epoch resumes at step 6 ...
        resumed, lines = run_train(run_dir, epochs=3, cadence=1)
        # ... and continues as a run that was never interrupted does
        straight, _ = run_train(straight_dir, epochs=3, cadence=1)
        named = [ln for ln in lines if ln.startswith("resumed at")]
        same = (sorted(resumed.losses) == [7, 8, 9]
                and all(resumed.losses[s] == straight.losses[s]
                        for s in (7, 8, 9))
                and all(first.losses[s] == straight.losses[s]
                        for s in first.losses)
                and all(torch.equal(v, straight.state.model.state_dict()[k])
                        for k, v in resumed.state.model.state_dict().items()))
        emit(phase="X3D-S resume", log=named, first_step=resumed.first_step,
             resumed_losses=resumed.losses, straight_losses=straight.losses,
             bit_identical=same)
        check(named == ["resumed at global step 6 (epoch 2, step-in-epoch "
                        "0)"] and resumed.first_step == 7,
              f"X3D-S resume: {named}, first step {resumed.first_step}")
        check(same, "the resumed X3D-S run differs from the uninterrupted")
        # steady steps on the uninterrupted run's state, the hooks apart
        step_fn = make_train_step(straight.state.model,
                                  cfg_s.NETWORK.WEIGHT_DECAY)
        batch = next(synthetic_batches(cfg_s, S_TRAIN_CLIPS, seed=SEED))
        gen_s = torch.Generator(device="cuda").manual_seed(SEED)
        times = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step_fn(straight.state, batch, gen_s)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        s_step_ms = sorted(times)[1]
        emit(phase="X3D-S train timing", clips=S_TRAIN_CLIPS,
             step_ms=times, step_ms_median=s_step_ms,
             clips_per_s=S_TRAIN_CLIPS / s_step_ms * 1e3,
             peak_memory_bytes=s_peak)
        del first, resumed, straight, step_fn, batch
        torch.cuda.empty_cache()

        # evaluate two batches of 8 videos x 10 views from the checkpoint
        zero_counts()
        metrics = run_cli(eval_cli.main, [
            f"--cfg={s_config}", f"--model_folder={run_dir}", "--synthetic",
            "--max_batches=2"])
        eval_launches = read_counts()
        ok = (len(metrics) == 1 and metrics[0]["count"] == 16.0
              and math.isfinite(metrics[0]["loss"])
              and eval_launches == {k: 2 * v for k, v in
                                    want_s_forward.items()})
        check(ok, f"X3D-S eval: {metrics}, launches {eval_launches}, want "
                  f"2 x {want_s_forward}")

        # serve one video from the checkpoint: the engine, then the tool
        views_s = cfg_s.TEST.NUM_TEMPORAL_VIEWS * cfg_s.TEST.NUM_SPATIAL_CROPS
        zero_counts()
        engine = InferenceEngine.from_checkpoint(cfg_s, run_dir, max_videos=1)
        video = np.random.default_rng(SEED).integers(
            0, 256, engine.clip_shape, dtype=np.uint8)
        probs = engine.predict(video)
        predict_launches = read_counts()
        # the model as the eval tool restores it
        eval_model = create_model(cfg_s, dtype=torch.bfloat16, init=False)
        CheckpointManager(f"{run_dir}/checkpoints", max_to_keep=0) \
            .restore_weights_only(create_train_state(cfg_s, eval_model))
        want_probs = InferenceEngine(cfg_s, eval_model,
                                     max_videos=1).predict(video)
        row_err = float(np.abs(probs.sum(-1) - 1.0).max())
        rows = run_cli(predict_cli.main, [
            f"--cfg={s_config}", f"--model_folder={run_dir}", "--synthetic",
            "--max_batches=1", "--batch_videos=1"])
        ok = (probs.shape == (1, cfg_s.NETWORK.NUM_CLASSES)
              and bool(np.isfinite(probs).all()) and row_err <= TOL_ROW_SUM
              and np.array_equal(probs, want_probs)
              and predict_launches == want_s_forward
              and len(rows) == 1 and len(rows[0]["top"]) == 5)
        check(ok, f"X3D-S predict: row sum err {row_err}, launches "
                  f"{predict_launches}, tool rows {rows}")

        # eval and 1-video times on the restored model
        eval_state = create_train_state(cfg_s, engine.model)
        eval_step = make_eval_step(engine.model)
        batch = next(synthetic_batches(cfg_s, cfg_s.TEST.BATCH_SIZE,
                                       is_training=False))
        eval_ms = time_ms(lambda: eval_step(eval_state, batch), iters=5)
        emit(phase="X3D-S eval and predict", eval=metrics,
             eval_launches=eval_launches, launches_per_forward=want_s_forward,
             eval_batch_clips=int(batch["video"].shape[0]),
             eval_batch_ms=eval_ms,
             eval_clips_per_s=batch["video"].shape[0] / eval_ms * 1e3,
             predict_1_video_ms=engine.device_latency_s(iters=10) * 1e3,
             predict_row_sum_err=row_err,
             predict_equals_eval_model=bool(np.array_equal(probs,
                                                           want_probs)),
             views=views_s, predict_tool=rows)
        del engine, eval_model, eval_state, batch
    torch.cuda.empty_cache()

    # --------------- 11. X3D-XS, -L and -XL: kernels, serving and training
    # Each variant at full width and depth from its YAML, bfloat16, random
    # weights from a seed: every kernel against its plain version at the
    # shapes its serving requests (1 and 8 videos) and its training step
    # (the config's batch) give it, float32 and bfloat16, timed with fewer
    # repeats (NEW_ITERS); the engine serving 1 and 8 videos; the bare
    # training step at the config's batch, L and XL with remat as
    # create_model resolves it ("auto": per block at 312²) and without,
    # the two bit for bit equal; a float32 step through the kernels against
    # the plain versions (X3D-XS: its stem's 4 frames are fewer than its 5
    # taps; X3D-XL: SCALE_RES2, widths 2 mod 4).
    def bodies():
        return {"K1": dict(k1_bodies), "K2": dict(k2_bodies),
                "K3": dict(k3_bodies), "K4 dx": dict(dx_bodies),
                "K4 dk": dict(dk_bodies), "K7": dict(k7_bodies),
                "K8": dict(k8_bodies)}

    def check_new_row(kname, where, row):
        """A row at a new variant's shape fails where the kernel is behind
        its plain version, or behind the generic body on the same inputs
        where the rule picked another body and the generic body takes
        HOST_BOUND_MS or more (below that time_fn reads the host's gaps
        between launches, which both bodies share).  K7's plain version is
        its library call, F.linear: K7's rows behind it are findings."""
        if kname == "K7" or row["n"] == 0:   # K7; a row off the path
            return
        check(row["ms"] < row["plain_ms"],
              f"{kname} {where}: {row['ms']} ms, behind the plain version's "
              f"{row['plain_ms']} ms")
        generic = row.get("generic_ms", row.get("gather_ms"))
        if row.get("body") not in (None, "generic", "gather") \
                and generic is not None and generic >= HOST_BOUND_MS:
            check(row["ms"] < generic,
                  f"{kname} {where}: the {row['body']} body ({row['ms']} ms) "
                  f"behind the generic body ({generic} ms)")

    def same_step(a, b):
        return (a[0] == b[0] and all(torch.equal(x, y)
                                     for x, y in zip(a[1], b[1]))
                and all(torch.equal(a[2][k], v) for k, v in b[2].items()))

    def x3d_variant(v):
        vcfg = variant_config(v)
        varch = build_arch(vcfg)
        views = vcfg.TEST.NUM_TEMPORAL_VIEWS * vcfg.TEST.NUM_SPATIAL_CROPS
        clips = vcfg.TRAIN.BATCH_SIZE
        kt = varch.temp_filter
        stem_k8 = depthwise.pbwd_eligible(
            stem_shape(vcfg, varch, clips), (kt, 1, 1), (1, 1, 1),
            ((kt // 2,) * 2, (0, 0), (0, 0)))
        out = {"rows": {}}
        rows = out["rows"]

        # every kernel against its plain version at this variant's shapes
        for B in (views, 8 * views):
            rows["K1", B] = k1_serving_rows(v, B, k1_cases(vcfg, varch, B),
                                            True)
            rows["K2", B] = k2_serving_rows(
                v, B, varch.temp_kernel,
                segment_cases(vcfg, varch, B, vcfg.DATA.TEST_CROP_SIZE), True)
            rows["K7", B] = k7_rows(v, f"serving, {B} clips", vcfg, varch, B,
                                    vcfg.DATA.TEST_CROP_SIZE, False)
        (_, rows["K1", "train"], k4, rows["K2", "train"],
         rows["K3", "train"], rows["K5", "train"],
         rows["K6", "train"]) = training_kernels(v, vcfg, varch, clips)
        rows["K4 dx", "train"], rows["K4 dk", "train"] = k4["dx"], k4["dk"]
        rows["K7", "train"] = k7_rows(v, "training", vcfg, varch, clips,
                                      vcfg.DATA.TRAIN_CROP_SIZE, True)
        if stem_k8:
            rows["K8", "train"] = [k8_row(
                f"X3D-{v} conv_1.conv_t", stem_shape(vcfg, varch, clips),
                (kt, 1, 1))]
        for (kname, path), rs in rows.items():
            for r in rs:
                check_new_row(kname, f"X3D-{v} {path} {r['name']}", r)
            keys = ("ms", "plain_ms", "library_ms", "bound_ms") + tuple(
                k for k in ("generic_ms",) if all(k in r for r in rs))
            total = {k: sum(r["n"] * r[k] for r in rs) for k in keys}
            emit(phase=f"{kname}, X3D-{v} path", variant=v, path=path,
                 launches=sum(r["n"] for r in rs), **total, **shares(total))

        # serving: the engine, requests of 1 and 8 videos
        engine1 = InferenceEngine.random_init(vcfg, max_videos=1, seed=SEED)
        engine8 = InferenceEngine(vcfg, engine1.model, max_videos=8)
        clips8 = np.random.default_rng(SEED).integers(
            0, 256, (8 * views,) + engine1.clip_shape[1:], dtype=np.uint8)
        ns = len(varch.stages)
        n2 = sum(len(b) - 1 for b in varch.stages)
        per_forward = dict.fromkeys(counters, 0) | {
            "K1": ns + 1, "K2": n2, "K7": 2 * (ns + n2) + ns + 1}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        served = []
        zero_counts()                       # X3D-v serving starts here
        for name, engine, batch_u8 in (("1 video", engine1, clips8[:views]),
                                       ("8 videos", engine8, clips8)):
            before = read_counts()
            probs = engine.predict(batch_u8)
            after = read_counts()
            served.append((name, engine, probs,
                           {k: after[k] - before[k] for k in after}))
        out["serve_launches"] = read_counts()      # ... and ends here
        out["serve_bodies"] = bodies()
        peak = torch.cuda.max_memory_allocated()
        want = {"K1": {"temporal": 2, "ring": 2 * ns, "generic": 0},
                "K2": {"ring": 2 * n2, "generic": 0},
                "K7": k7_want(vcfg, varch, False, 2)}
        for kname, w in want.items():
            check(out["serve_bodies"][kname] == w,
                  f"X3D-{v} serving {kname} bodies "
                  f"{out['serve_bodies'][kname]}, want {w}")
        for name, engine, probs, launches in served:
            n_videos = probs.shape[0]
            finite = bool(np.isfinite(probs).all())
            row_err = float(np.abs(probs.sum(-1) - 1.0).max())
            dev_s = engine.device_latency_s(iters=NEW_ITERS)
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine.predict(clips8[:n_videos * views])
                walls.append(time.perf_counter() - t0)
            emit(phase=f"X3D-{v} serve", request=name,
                 clips=n_videos * views, probs_shape=list(probs.shape),
                 finite=finite, max_row_sum_err=row_err,
                 device_ms=dev_s * 1e3,
                 clips_per_s=n_videos * views / dev_s,
                 wall_ms_median=float(np.median(walls)) * 1e3,
                 peak_memory_bytes=peak, launches=launches,
                 bodies=out["serve_bodies"])
            check(probs.shape == (n_videos, vcfg.NETWORK.NUM_CLASSES)
                  and finite and row_err <= TOL_ROW_SUM,
                  f"X3D-{v} serve {name} probabilities")
            check(launches == per_forward,
                  f"X3D-{v} serve {name}: launches {launches}, want "
                  f"{per_forward}")
        del engine1, engine8, served
        torch.cuda.empty_cache()

        # training: the bare step at the config's batch, with remat as
        # create_model resolves it from the YAML and, where that is on,
        # without and with "convs"; ``held``: what the script held before
        # (its earlier phases' tensors), which the peaks include
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        model = create_model(vcfg, dtype=torch.bfloat16, seed=SEED)
        state = create_train_state(vcfg, model)
        step_fn = make_train_step(model, vcfg.NETWORK.WEIGHT_DECAY)
        batch = next(synthetic_batches(vcfg, clips, seed=SEED))
        gen_v = torch.Generator(device="cuda").manual_seed(SEED)
        snap0 = snapshot(state)
        modes = [model.remat] + (["off", "convs"] if model.remat != "off"
                                 else [])
        out["train"] = {}
        for mode in modes:
            model.remat = mode
            restore(state, snap0)
            want = want_step_of(varch, stem_k8, mode)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            steps = []
            zero_counts()                   # X3D-v training starts here
            for i in range(TRAIN_STEPS):
                before = read_counts()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                state, metrics = step_fn(state, batch, gen_v)
                end.record()
                end.synchronize()
                wall = time.perf_counter() - t0
                after = read_counts()
                steps.append(dict(step=i, loss=float(metrics["loss"]),
                                  device_ms=start.elapsed_time(end),
                                  wall_ms=wall * 1e3,
                                  launches={k: after[k] - before[k]
                                            for k in after}))
            launches = read_counts()        # ... and ends here
            got = bodies()
            peak = torch.cuda.max_memory_allocated()
            steady = sorted(s["device_ms"] for s in steps[1:])
            step_ms = steady[len(steady) // 2]
            out["train"][mode] = dict(
                step_ms_median_after_first=step_ms,
                first_step_ms=steps[0]["device_ms"],
                clips_per_s=clips / step_ms * 1e3, peak_memory_bytes=peak,
                peak_above_held_bytes=peak - held,
                launches=launches, launches_per_step=want, bodies=got)
            emit(phase=f"X3D-{v} train timing", clips=clips, remat=mode,
                 steps=steps, **out["train"][mode])
            for s_ in steps:
                check(math.isfinite(s_["loss"]),
                      f"X3D-{v} train step {s_['step']} loss")
                check(s_["launches"] == want,
                      f"X3D-{v} remat {mode} step {s_['step']} launches "
                      f"{s_['launches']}, want {want}")
            want_b = bodies_of_steps(vcfg, varch, want, TRAIN_STEPS,
                                     stem_k8, mode)
            for kname, w in want_b.items():
                check(got[kname] == w, f"X3D-{v} remat {mode} {kname} "
                                       f"bodies {got[kname]}, want {w}")

        # one step from one state, twice with the resolved remat, once
        # without and once with "convs": bit for bit the same loss,
        # gradients, parameters and running statistics (deterministic
        # kernels; the recompute repeats the same launches or takes the
        # kept outputs)
        torch.backends.cudnn.deterministic = True
        runs = []
        for mode in [modes[0]] + modes:
            model.remat = mode
            restore(state, snap0)
            state, metrics = step_fn(state, batch, gen_v)
            runs.append((float(metrics["loss"]),
                         [p.grad.clone() for p in model.parameters()],
                         copy.deepcopy(model.state_dict())))
        torch.backends.cudnn.deterministic = False
        repeat = same_step(runs[0], runs[1])
        vs_off = same_step(runs[0], runs[2]) if len(modes) > 1 else None
        convs_vs_off = same_step(runs[3], runs[2]) if len(modes) > 2 \
            else None
        emit(phase=f"X3D-{v} train determinism", remat=modes,
             losses=[r[0] for r in runs], repeat_bit_identical=repeat,
             remat_vs_off_bit_identical=vs_off,
             convs_vs_off_bit_identical=convs_vs_off)
        check(repeat, f"X3D-{v}: two runs of one training step differ")
        check(vs_off is not False, f"X3D-{v}: the step with remat "
                                   f"{modes[0]} differs from the step without")
        check(convs_vs_off is not False, f"X3D-{v}: the step with remat "
                                         "convs differs from the step without")
        del model, state, step_fn, batch, runs, snap0
        torch.cuda.empty_cache()
        if v in ("XS", "XL"):
            f32_step_check(emit, check, vcfg, v, want_step_of(
                varch, stem_k8, create_model(vcfg, device="meta").remat),
                calibrate=True)
        return out

    timing["iters"] = NEW_ITERS
    new = {v: x3d_variant(v) for v in NEW_VARIANTS}
    timing["iters"] = ITERS

    # ----------------------------------------------- 11b. real input data
    shard_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_input_")
    try:
        input_entry = input_phase(emit, check, shard_dir.name)
        # ------------------------------- 11c. long-cycle multigrid training
        multigrid = multigrid_phase(emit, check,
                                    os.path.join(shard_dir.name, "train-*"))
    finally:
        shard_dir.cleanup()

    # ------------------------- 11d. the reference's TF checkpoint imported
    imported = import_phase(emit, check)

    # ----------------------------------- 11e. the time-folded layout
    fold_phase(emit, check)

    # ------------- 12. data parallelism, grouped BN and the split head
    grouped = parallel_phase(emit, check)

    # ---------------------------------- 13. the serving forward exported
    exported = export_phase(emit, check)

    # ---------------------------- 14. raw videos and the dataset tools
    raw = raw_video_phase(emit, check)

    # ---------- 15. the developer tools: memory, ab, profile, roofline
    tools_phase(emit, check, peaks={
        m: new["L"]["train"][m]["peak_above_held_bytes"]
        for m in ("off", "block", "convs")})

    # ----------------------------------------------- 16. the kernel line
    def worst(*row_lists):
        return max(r["max_abs_err_f32"] for rows in row_lists for r in rows)

    csrc = "x3d_tpu_torch/kernels/csrc/"
    entries = [
        (summary("depthwise_conv3d", "cuda", csrc + "depthwise.cu",
                 "x3d_tpu/ops/dw_batchminor.py:101, "
                 "x3d_tpu/ops/pallas_dw.py:97", k1_rows,
                 max(train_err["K1"], train_err_s["K1"]))
         | {"bodies_serving": serve_k1_bodies,
            "bodies_training": train_k1_bodies,
            "bodies_x3d_s_training": s_k1_bodies,
            "generic_ms": sum(r["n"] * r["generic_ms"] for r in k1_rows),
            "epilogue_ms": sum(r["n"] * r["epilogue_ms"] for r in k1_rows),
            "training_step_ms": sum(r["n"] * r["ms"] for r in k1_train)},
         "K1", "serve"),
        (summary("dw_bn_act_conv", "cuda", csrc + "dw_fused.cu",
                 "x3d_tpu/ops/dw_fused.py:298", k2_rows,
                 max(train_err["K2"], train_err_s["K2"],
                     worst(*k2_serving.values())))
         | {"bodies_serving": serve_k2_bodies,
            "bodies_training": train_k2_bodies,
            "bodies_x3d_s_training": s_k2_bodies,
            "generic_ms": sum(r["n"] * r["generic_ms"] for r in k2_rows),
            "epilogue_ms": sum(r["n"] * r["epilogue_ms"] for r in k2_rows),
            "training_step_ms": sum(r["n"] * r["ms"] for r in k2_train)},
         "K2", "serve"),
        (summary("dw_bn_act_conv_bwd", "cuda", csrc + "dw_fused_bwd.cu",
                 "x3d_tpu/ops/dw_fused.py:346", k3_rows, worst(k3_rows_s))
         | {"bodies_training": train_k3_bodies,
            "bodies_x3d_s_training": s_k3_bodies,
            "generic_ms": sum(r["n"] * r.get("generic_ms", r["ms"])
                              for r in k3_rows)}, "K3", "train"),
        (summary("depthwise_conv3d_dx", "cuda", csrc + "depthwise_bwd.cu",
                 "x3d_tpu/ops/dw_batchminor.py:231 (dx by _fwd_kernel), "
                 "x3d_tpu/ops/pallas_dw.py:221 (dx by _fwd_kernel)",
                 k4_rows["dx"], worst(k4_rows_s["dx"]))
         | {"bodies_training": train_dx_bodies,
            "gather_ms": sum(r["n"] * r.get("gather_ms", r["ms"])
                             for r in k4_rows["dx"])}, "K4 dx", "train"),
        (summary("depthwise_conv3d_dk", "cuda", csrc + "depthwise_bwd.cu",
                 "x3d_tpu/ops/dw_batchminor.py:120, "
                 "x3d_tpu/ops/pallas_dw.py:123", k4_rows["dk"],
                 worst(k4_rows_s["dk"]))
         | {"bodies_training": train_dk_bodies,
            "bodies_x3d_s_training": s_dk_bodies,
            "generic_ms": sum(r["n"] * r["generic_ms"]
                              for r in k4_rows["dk"]),
            "x3d_s_step_ms": sum(r["n"] * r["ms"] for r in k4_rows_s["dk"])},
         "K4 dk", "train"),
        (summary("pw_conv_stats", "cuda", csrc + "pw_stats.cu",
                 "x3d_tpu/ops/pw_batchminor.py:132", k5_rows,
                 worst(k5_rows_s)), "K5", "train"),
        (summary("pw_act_conv_stats", "cuda", csrc + "pw_stats.cu",
                 "x3d_tpu/ops/pw_batchminor.py:260", k6_rows,
                 worst(k6_rows_s)), "K6", "train"),
        # K7 and K8 at the shapes of X3D-S's training step (forward and dx;
        # the stem's backward); their X3D-M rows are on the lines above
        (summary("pw_conv", "cuda", csrc + "pointwise.cu",
                 "x3d_tpu/ops/pw_batchminor.py:56", k7[("S", "training")],
                 worst(*k7.values()))
         | {"bodies_serving": serve_k7_bodies,
            "bodies_training": train_k7_bodies,
            "bodies_x3d_s_training": s_k7_bodies,
            "generic_ms": sum(r["n"] * r["generic_ms"]
                              for r in k7[("S", "training")]),
            # the 1-video X3D-M forward's calls with an epilogue
            "serving_epilogue_ms": sum(
                r["n"] * r["epilogue_ms"]
                for r in k7[("M", f"serving, {CLIPS} clips")]
                if "epilogue" in r),
            "serving_without_epilogue_ms": sum(
                r["n"] * r["ms"]
                for r in k7[("M", f"serving, {CLIPS} clips")]
                if "epilogue" in r)},
         "K7", "s_train"),
        (summary("depthwise_conv3d_pbwd", "cuda", csrc + "depthwise_pbwd.cu",
                 "x3d_tpu/ops/dw_fused.py:418", [k8_s],
                 k8_m["max_abs_err_f32"])
         | {"k4_dx_ms": k8_s["k4_dx_ms"], "k4_dk_ms": k8_s["k4_dk_ms"],
            "bodies_training": train_k8_bodies,
            "bodies_x3d_s_training": s_k8_bodies,
            "plan": k8_s["plan"], "generic_ms": k8_s["generic_ms"],
            "x3d_m_step_ms": k8_m["ms"],
            "x3d_m_generic_ms": k8_m["generic_ms"],
            "x3d_m_bound_ms": k8_m["bound_ms"]},
         "K8", "s_train"),
        ({"name": "fma_chain", "route": "cuda",
          "source": csrc + "fma_probe.cu",
          "replaces": "x3d_tpu/tools/vpu_probe.py:40",
          "max_abs_err": k9_err[torch.float32], "ms": k9_ms,
          "plain_ms": k9_plain_ms, "bound_ms": k9_bound, "bound_by": k9_by,
          "library_ms": None}, "K9", "probe"),
    ]
    paths = {"serve": (serve_launches, "X3D-M serving"),
             "train": (train_launches,
                       f"X3D-M training, {TRAIN_STEPS} steps"),
             "s_train": (s_train_launches,
                         "X3D-S train tool, 2 epochs of 3 steps"),
             "probe": (probe_launches, "the multiply-add probe tool")}
    kernels_line = []
    for entry, key, path in entries:
        entry["launches"] = paths[path][0][key]
        entry["path"] = paths[path][1]
        entry["launches_serving"] = serve_launches[key]
        entry["launches_training"] = train_launches[key]
        entry["launches_x3d_s_training"] = s_train_launches[key]
        # X3D-XS, -L and -XL: launches and bodies on their serving path (1
        # and 8 videos) and over TRAIN_STEPS steps with each remat mode,
        # and the kernel's time summed over one training step's launches
        entry["x3d_xs_l_xl"] = {v: {
            "launches_serving": n["serve_launches"][key],
            "bodies_serving": n["serve_bodies"].get(key),
            "launches_training": {m: t["launches"][key]
                                  for m, t in n["train"].items()},
            "bodies_training": {m: t["bodies"].get(key)
                                for m, t in n["train"].items()},
            "training_step_ms": sum(r["n"] * r["ms"] for r in
                                    n["rows"].get((key, "train"), []))}
            for v, n in new.items()}
        # X3D-M's multigrid tool run: launches and bodies over each phase's
        # epochs (phase 0: 1 step, 1: 2, 2: 4, 3: 16)
        entry["multigrid_x3d_m"] = {
            "launches_by_phase": {ph: n[key] for ph, n in
                                  multigrid["launches"].items()},
            "bodies_by_phase": {ph: b.get(key) for ph, b in
                                multigrid["bodies"].items()}}
        # the 1-video request on the imported X3D-M weights
        entry["launches_imported_x3d_m"] = imported["request_launches"][key]
        # phase 13's exported X3D-M programs (default, not portable): a
        # 1-video forward's launches by dtype
        if key in ("K1", "K2", "K7"):
            entry["launches_exported_x3d_m"] = {
                dt: n[key] for dt, n in exported["launches"].items()}
        # phase 12's bfloat16 X3D-M steps by bn_groups (1 = synced):
        # launches and bodies over PAR_TIMED_STEPS steps
        entry["grouped_bn_x3d_m"] = {
            g: {"launches": n["launches"][key],
                "bodies": n["bodies"].get(key)}
            for g, n in grouped.items()}
        check(entry["launches"] > 0,
              f"{entry['name']} never launched on its main path")
        kernels_line.append(entry)
    check(input_entry["launches"] > 0,
          "clip_prep never launched on its main path")
    # phase 14: the clip kernel on the raw-video path (a text list of
    # MJPEG AVIs, X3D-M training and eval)
    input_entry["launches_raw_video"] = raw["launches"]
    input_entry["raw_video"] = {k: raw[k] for k in (
        "path", "cases", "nvjpeg_decode_launches", "max_abs_err",
        "loader_clips_per_s")}
    input_entry["max_abs_err"] = max(input_entry["max_abs_err"],
                                     raw["max_abs_err"])
    check(raw["launches"] > 0,
          "clip_prep never launched on the raw-video path")
    kernels_line.append(input_entry)
    print(json.dumps({"card": card, "kernels": kernels_line}))
    if failures:
        fail(f"{len(failures)} check(s) failed: {failures}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
