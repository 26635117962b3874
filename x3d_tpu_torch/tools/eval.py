"""Evaluation CLI: multi-view ensemble testing of a trained checkpoint.

    python -m x3d_tpu_torch.tools.eval \
        --cfg=x3d_tpu_torch/configs/kinetics/X3D_S.yaml \
        --model_folder=/tmp/x3d_s --synthetic --max_batches=2

Flags kept verbatim from the JAX package's ``tools/eval.py``: cfg,
test_file_pattern, model_folder, gpus, tfrecord, native_loader,
native_threads, synthetic, max_batches, opts, profile_batch,
allow_random_init.  Added: ``--device`` (cuda by default).  Prints one JSON
line: loss, acc, top_5_acc, count.

Real data: ``--tfrecord --test_file_pattern=...`` reads TFRecord shards
of JPEG frames through ``data.InputReader`` (every batch unless
``--max_batches``), views and crops as the config says.  Without
``--tfrecord`` (the JAX tool's default) the pattern is a text file of
``<video path> <label>`` lines, read by the same reader (Motion-JPEG AVIs
through nvJPEG on the card, other videos decoded on the host where a video
library is installed).  The port has one
loader where the JAX package has two; ``--native_loader`` selects it too,
with ``--native_threads`` host threads (otherwise the host's cores, at
most 8), and needs ``--tfrecord`` (a usage error otherwise, as in the JAX
tool).

Several GPUs: ``--gpus N`` under ``torchrun --nproc_per_node=N`` (the
train tool's docstring says how); each data rank evaluates its share of
the shards (or its own synthetic batches) at ``TEST.BATCH_SIZE // data``
videos a batch, the four sums are added over the ranks once at the end,
and rank 0 prints the line.
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import os

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    from x3d_tpu_torch.tools.common import (add_bool_flag, add_common_flags,
                                            add_parallel_flags)

    p = argparse.ArgumentParser(
        prog="x3d_tpu_torch.tools.eval",
        description="Evaluate an X3D checkpoint on CUDA cards, one process "
                    "a card.")
    p.add_argument("--cfg", required=True,
                   help="(Relative) path to config (.yaml) file.")
    p.add_argument("--test_file_pattern", default=None,
                   help="TFRecord pattern or label-file path for test data.")
    p.add_argument("--model_folder", required=True,
                   help="Directory holding checkpoints (from the train CLI).")
    p.add_argument("--gpus", type=int, default=0,
                   help="Number of GPUs (processes under torchrun); 0 or 1: "
                        "one card.")
    add_bool_flag(p, "tfrecord", False, "Data is TFRecord shards.")
    add_bool_flag(p, "native_loader", False,
                  "The JAX package's C++ clip loader; the port has one "
                  "loader, which this selects too.")
    p.add_argument("--native_threads", type=int, default=1,
                   help="Host threads of the loader with --native_loader.")
    add_bool_flag(p, "synthetic", False, "Evaluate on synthetic data.")
    p.add_argument("--max_batches", type=int, default=None,
                   help="Cap evaluation batches.")
    p.add_argument("--profile_batch", type=int, default=0,
                   help="Capture a device trace around this (1-based) eval "
                        "batch; 0 disables.")
    add_bool_flag(p, "allow_random_init", False,
                  "Evaluate a randomly initialised model when no checkpoint "
                  "exists (smoke tests only).")
    add_common_flags(p)
    add_parallel_flags(p)
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from x3d_tpu_torch.data import InputReader, synthetic_batches
    from x3d_tpu_torch.parallel import local_batch
    from x3d_tpu_torch.tools.common import (flat_opts, load_config,
                                            setup_runtime)
    from x3d_tpu_torch.train import create_train_state, make_eval_step
    from x3d_tpu_torch.train.checkpoint import CheckpointManager
    from x3d_tpu_torch.train.hooks import WandbHook
    from x3d_tpu_torch.train.loop import evaluate

    cfg = load_config(args.cfg, flat_opts(args.opts))

    # Fail fast on a missing checkpoint, before any device work: a typo'd
    # --model_folder must not silently yield chance-level accuracy.
    ckpt_dir = os.path.join(args.model_folder, "checkpoints")
    have_ckpt = os.path.isdir(ckpt_dir) and \
        CheckpointManager(ckpt_dir, max_to_keep=0).latest_epoch() is not None
    if not have_ckpt and not args.allow_random_init:
        parser.error(f"No checkpoint found in {ckpt_dir}; pass "
                     "--allow_random_init to evaluate an untrained model.")
    if not args.synthetic:
        if not args.test_file_pattern:
            parser.error("--test_file_pattern required unless --synthetic")
        if args.native_loader and not args.tfrecord:
            parser.error("--native_loader requires --tfrecord")

    device, model, dtype = setup_runtime(cfg, args.gpus, True, False,
                                         device=args.device,
                                         init_method=args.init_method)
    mesh = model.mesh
    main_rank = mesh is None or mesh.is_main
    batch = local_batch(cfg.TEST.BATCH_SIZE, mesh)
    if args.synthetic:
        batches = itertools.islice(
            synthetic_batches(cfg, batch, is_training=False, dtype=dtype,
                              device=device,
                              seed=mesh.data_rank if mesh else 0),
            args.max_batches or 4)
    else:
        reader = InputReader(
            cfg, is_training=False, device=device, dtype=dtype,
            use_tfrecord=args.tfrecord,
            num_threads=args.native_threads if args.native_loader else None,
            **(dict(host_id=mesh.data_rank, host_count=mesh.data)
               if mesh else {}))
        batches = reader(args.test_file_pattern, batch)
        if args.max_batches:
            batches = itertools.islice(batches, args.max_batches)
    state = create_train_state(cfg, model, steps_per_epoch=1)

    if not have_ckpt:
        log.warning("No checkpoint in %s -- evaluating RANDOM INIT "
                    "(--allow_random_init).", ckpt_dir)
    else:
        mgr = CheckpointManager(ckpt_dir, max_to_keep=0)
        state = mgr.restore_weights_only(state)
        log.info("restored weights from key %d", mgr.latest_epoch())
        mgr.close()

    metrics = evaluate(
        make_eval_step(model), state, batches,
        profile_batch=args.profile_batch if main_rank else 0,
        profile_dir=os.path.join(args.model_folder, "eval_profile"))
    log.info("eval: %s", metrics)
    if main_rank:
        print(json.dumps({k: round(float(v), 6)
                          for k, v in metrics.items()}), flush=True)
        wandb_hook = WandbHook(cfg, job_type="eval",
                               log_dir=args.model_folder)
        wandb_hook.log_metrics(metrics)
        wandb_hook.on_train_end()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
