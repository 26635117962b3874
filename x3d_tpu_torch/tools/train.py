"""Training CLI, flag-compatible with the JAX package's ``tools/train.py``.

    python -m x3d_tpu_torch.tools.train \
        --config=x3d_tpu_torch/configs/kinetics/X3D_S.yaml \
        --synthetic --model_dir=/tmp/x3d_s

Flags kept verbatim: config, train_file_pattern, val_file_pattern,
model_dir, pretrained_ckpt, num_gpus, save_checkpoints_step,
mixed_precision (bfloat16 compute; no loss scaling needed), use_tfrecord,
debug, multihost, synthetic, native_loader, multigrid, steps_per_epoch,
epochs, profile_batch, opts.  Added: ``--device`` (cuda by default; the run
raises when there is no card unless ``--device cpu`` is passed).

Checkpoints go to ``<model_dir>/checkpoints``, keyed by the global step; a
second run with the same ``--model_dir`` resumes from the latest one, in
the middle of an epoch where the last save was there.

Real data: ``--use_tfrecord --train_file_pattern=... [--val_file_pattern=
...]`` reads TFRecord shards of JPEG frames through ``data.InputReader``
(nvJPEG and the clip kernel on the card; Pillow and the plain version with
``--device cpu``), validating at each epoch's end.  Without
``--use_tfrecord`` (the JAX tool's default) the patterns are text files of
``<video path> <label>`` lines (``tools/create_label`` writes them), read
by the same reader: Motion-JPEG AVIs through nvJPEG on the card, other
videos decoded on the host by OpenCV (or decord, imageio) where one is
installed, training at the exact geometry.  The port has one
loader where the JAX package has two (tf.data and the C++ clip loader):
``--native_loader`` selects it too, with ``--native_threads`` host threads
(default: the host's cores, at most 8); as in the JAX tool it needs
``--use_tfrecord`` (a usage error otherwise).

Long-cycle multigrid training: ``--multigrid`` (or ``MULTIGRID.ENABLE``)
trains each epoch at its phase's clip shape and batch
(``train/multigrid.py``), on synthetic batches or the shards, with one
iterator a phase; with ``--val_file_pattern`` and
``MULTIGRID.BN_RECALC_BATCHES`` the BN statistics are re-estimated on
base-shape batches before each validation.  As in the JAX tool it refuses
``--native_loader`` (a usage error).

Several GPUs: one process per GPU under torchrun, which sets each
process's ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``::

    torchrun --nproc_per_node=4 -m x3d_tpu_torch.tools.train \
        --config=... --model_dir=... --num_gpus=4

and ``--multihost`` with torchrun's ``--nnodes``/``--node_rank``/
``--master_addr`` on every node (the tool does not start processes
itself; ``--num_gpus`` above 1 without torchrun's environment raises).
Each process trains on ``cuda:LOCAL_RANK`` (``--device cpu``: gloo on the
CPU) over the ``TPU.MESH_DATA`` x ``TPU.MESH_MODEL`` mesh: a data rank
takes ``TRAIN.BATCH_SIZE // data`` clips a step (synthetic batches drawn
from its own seed, or its share of the shards), the gradients are averaged
over the data group, ``TPU.SYNC_BN`` chooses global or per-rank BN
statistics, and a model axis splits the head.  Rank 0 logs and writes the
checkpoints (full tensors, whatever the mesh) and every rank resumes from
them.  ``--init_method`` replaces torchrun's ``env://`` rendezvous (e.g.
``file://``).
"""

from __future__ import annotations

import argparse
import itertools
import logging
import os

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    from x3d_tpu_torch.tools.common import (add_bool_flag, add_common_flags,
                                            add_parallel_flags)

    p = argparse.ArgumentParser(
        prog="x3d_tpu_torch.tools.train",
        description="Train X3D on CUDA cards, one process a card.")
    p.add_argument("--config", required=True,
                   help="(Relative) path to config (.yaml) file.")
    p.add_argument("--train_file_pattern", default=None,
                   help="TFRecord pattern or label-file path for training "
                        "data.")
    p.add_argument("--val_file_pattern", default=None,
                   help="TFRecord pattern or label-file path for validation "
                        "data.")
    p.add_argument("--model_dir", required=True,
                   help="Directory for checkpoints and TensorBoard events.")
    p.add_argument("--pretrained_ckpt", default=None,
                   help="Checkpoint directory for warm-starting weights.")
    p.add_argument("--num_gpus", type=int, default=0,
                   help="Number of GPUs (processes under torchrun) on this "
                        "node; 0 or 1: one card.")
    p.add_argument("--save_checkpoints_step", type=int, default=None,
                   help="Checkpoint, logging and TensorBoard cadence in "
                        "steps.")
    add_bool_flag(p, "mixed_precision", True, "bfloat16 compute.")
    add_bool_flag(p, "use_tfrecord", False,
                  "Data is TFRecord shards (vs a label text file).")
    add_bool_flag(p, "debug", False,
                  "Anomaly checks, fixed seed, tensor health dump, debug "
                  "logging.")
    add_bool_flag(p, "multihost", False, "Multi-host training.")
    add_bool_flag(p, "synthetic", False,
                  "Train on synthetic data (no dataset needed).")
    add_bool_flag(p, "native_loader", False,
                  "The JAX package's C++ clip loader; the port has one "
                  "loader, which this selects too.")
    p.add_argument("--native_threads", type=int, default=None,
                   help="Host threads of the loader (default: the host's "
                        "cores, at most 8).")
    add_bool_flag(p, "multigrid", False, "Long-cycle multigrid training.")
    p.add_argument("--steps_per_epoch", type=int, default=None,
                   help="Override DATASET_SIZE // BATCH_SIZE.")
    p.add_argument("--epochs", type=int, default=None,
                   help="Override TRAIN.EPOCHS.")
    p.add_argument("--profile_batch", type=int, default=0,
                   help="Capture a device trace around this global step.")
    add_common_flags(p)
    add_parallel_flags(p)
    return p


def main(argv=None, extra_hooks=()) -> int:
    """Run the CLI; ``extra_hooks`` (for callers in the same process) are
    appended to the loop's hooks."""
    parser = build_parser()
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from x3d_tpu_torch.data import InputReader, synthetic_batches
    from x3d_tpu_torch.parallel import local_batch
    from x3d_tpu_torch.tools.common import (flat_opts, load_config,
                                            setup_runtime)
    from x3d_tpu_torch.train import (create_train_state, make_eval_step,
                                     make_train_step)
    from x3d_tpu_torch.train.checkpoint import CheckpointManager
    from x3d_tpu_torch.train.hooks import (
        CheckpointHook, LoggingHook, ProfileHook, TensorBoardHook, WandbHook)
    from x3d_tpu_torch.train.loop import fit
    from x3d_tpu_torch.train.multigrid import (MultigridSchedule,
                                               fit_multigrid,
                                               make_bn_recalibrator)

    if not args.synthetic and not args.train_file_pattern:
        parser.error(
            "--train_file_pattern is required unless --synthetic is set")
    cfg = load_config(args.config, flat_opts(args.opts))
    multigrid = args.multigrid or cfg.MULTIGRID.ENABLE
    if multigrid and args.native_loader:
        # the JAX tool's usage error: its C++ loader has one geometry
        parser.error("--multigrid needs a reader per phase geometry, which "
                     "the JAX package's --native_loader cannot give; drop "
                     "--native_loader")
    if args.native_loader and not args.use_tfrecord and not args.synthetic:
        # the JAX tool's usage error: its C++ loader reads shards only
        parser.error("--native_loader requires --use_tfrecord (it reads "
                     "TFRecord shards, not raw videos)")

    os.makedirs(args.model_dir, exist_ok=True)
    seed = 1111 if args.debug else 0       # the reference's debug seed
    device, model, dtype = setup_runtime(
        cfg, args.num_gpus, args.mixed_precision, args.debug,
        device=args.device, seed=seed, multihost=args.multihost,
        init_method=args.init_method)
    mesh = model.mesh
    main_rank = mesh is None or mesh.is_main
    # a data rank's batches: its share of the global batch, synthetic ones
    # drawn from its own seed, the shards split between the data ranks
    data_seed = seed + (mesh.data_rank if mesh is not None else 0)
    hosts = dict(host_id=mesh.data_rank, host_count=mesh.data) \
        if mesh is not None else {}

    batch = cfg.TRAIN.BATCH_SIZE
    steps_per_epoch = args.steps_per_epoch or max(
        1, cfg.TRAIN.DATASET_SIZE // batch)
    epochs = args.epochs or cfg.TRAIN.EPOCHS

    schedule = None
    if multigrid:
        schedule = MultigridSchedule(cfg, steps_per_epoch, epochs)
        log.info("multigrid long-cycle schedule:\n%s", schedule.describe())

    threads = args.native_threads if args.native_loader else None

    def train_batches(train_cfg, global_batch):
        batch_size = local_batch(global_batch, mesh)
        if args.synthetic:
            return synthetic_batches(train_cfg, batch_size, is_training=True,
                                     dtype=dtype, seed=data_seed,
                                     device=device)
        reader = InputReader(train_cfg, is_training=True, seed=seed,
                             num_threads=threads, device=device, dtype=dtype,
                             use_tfrecord=args.use_tfrecord, **hosts)
        return reader(args.train_file_pattern, batch_size)

    def batches_for_phase(phase):
        """Multigrid: a train iterator at one phase's geometry (a data
        rank's share of the phase's batch)."""
        return train_batches(phase.apply_to_config(cfg), phase.batch_size)

    val_fn = None
    if not args.synthetic and args.val_file_pattern:
        val_reader = InputReader(cfg, is_training=False, num_threads=threads,
                                 device=device, dtype=dtype,
                                 use_tfrecord=args.use_tfrecord, **hosts)

        def val_fn():
            return val_reader(args.val_file_pattern,
                              local_batch(cfg.TEST.BATCH_SIZE, mesh))

    # model state (+ resume / warm start)
    state = create_train_state(
        cfg, model, steps_per_epoch=steps_per_epoch,
        schedule=schedule.make_lr_schedule() if multigrid else None)
    ckpt_dir = os.path.join(args.model_dir, "checkpoints")
    ckpt = CheckpointManager(ckpt_dir)
    state, restored_key = ckpt.restore(state)
    initial_epoch = initial_step_in_epoch = 0
    if restored_key:
        # the restored optimizer step is authoritative; the LR schedule
        # resumes with it because it is a function of the step
        resume_step = int(state.step)
        if multigrid:
            initial_epoch, initial_step_in_epoch = (
                schedule.position_for_step(resume_step))
        else:
            initial_epoch = resume_step // steps_per_epoch
            initial_step_in_epoch = resume_step % steps_per_epoch
        log.info("resumed at global step %d (epoch %d, step-in-epoch %d)",
                 resume_step, initial_epoch, initial_step_in_epoch)
    elif args.pretrained_ckpt:
        state = ckpt.restore_weights_only(state, args.pretrained_ckpt)
        log.info("warm-started from %s", args.pretrained_ckpt)

    if args.debug:
        # per-module output health of the first batch, next to the
        # checkpoints (every rank runs the forward, rank 0 writes)
        from x3d_tpu_torch.train.debug import dump_tensor_health

        sample = next(synthetic_batches(
            cfg, local_batch(batch, mesh), is_training=True, dtype=dtype,
            seed=data_seed, device=device))
        dump_tensor_health(model, state, sample["video"],
                           os.path.join(args.model_dir, "debug_health.json")
                           if main_rank else None)

    train_step = make_train_step(model, cfg.NETWORK.WEIGHT_DECAY)
    cadence = args.save_checkpoints_step or 50
    # every rank saves (the head's shards are joined there; rank 0 writes);
    # the other hooks act on rank 0 only.  WandbHook first:
    # WANDB.TENSORBOARD patches the TensorBoard sync before the
    # TensorBoardHook creates its writer
    hooks = [
        WandbHook(cfg, job_type="train", log_dir=args.model_dir,
                  checkpoint_dir=ckpt_dir),
        LoggingHook(log_every=cadence),
        TensorBoardHook(args.model_dir, update_freq=cadence),
    ] if main_rank else []
    hooks.append(CheckpointHook(ckpt,
                                every_n_steps=args.save_checkpoints_step))
    if args.profile_batch and main_rank:
        hooks.append(ProfileHook(args.model_dir, args.profile_batch))
    hooks.extend(extra_hooks)
    eval_step = make_eval_step(model) if val_fn else None

    if multigrid:
        bn_recal_fn = recal_iter = None
        if cfg.MULTIGRID.BN_RECALC_BATCHES > 0 and val_fn is not None:
            n = cfg.MULTIGRID.BN_RECALC_BATCHES
            recal_iter = batches_for_phase(schedule.phases[-1])
            bn_recal_fn = make_bn_recalibrator(
                model, lambda: itertools.islice(recal_iter, n), n, seed,
                momentum=cfg.NETWORK.BN.MOMENTUM)
        try:
            fit_multigrid(
                cfg, state, train_step, schedule, batches_for_phase,
                seed=seed, initial_epoch=initial_epoch,
                initial_step_in_epoch=initial_step_in_epoch,
                eval_step=eval_step, val_batches_fn=val_fn, hooks=hooks,
                metrics_every=cadence, bn_recal_fn=bn_recal_fn)
        finally:
            if recal_iter is not None:
                recal_iter.close()
        ckpt.close()
        return 0

    train_iter = train_batches(cfg, batch)
    try:
        fit(
            cfg,
            state,
            train_step,
            train_iter,
            steps_per_epoch=steps_per_epoch,
            epochs=epochs,
            seed=seed,
            initial_epoch=initial_epoch,
            eval_step=eval_step,
            val_batches_fn=val_fn,
            hooks=hooks,
            metrics_every=cadence,
            initial_step_in_epoch=initial_step_in_epoch,
        )
    finally:
        train_iter.close()
    ckpt.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
