"""Multi-process dry run on the CPU: X3D-M's train, eval, grouped-BN and
multigrid coarse-phase steps over ``n`` gloo ranks.

    python -m x3d_tpu_torch.tools.dryrun [N]

The counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``:
``n`` processes (``torch.multiprocessing``, spawn), one gloo rank each on
the CPU, on a mesh with a model axis of 2 where ``n`` is even and at least
4 (the head split) and data parallel over the rest; X3D-M at full width
and depth on 4x32² clips, 2 clips a rank, float32, weights from one seed.
Rank 0 prints one line starting ``dryrun_multigpu OK``; any failure raises.
"""

from __future__ import annotations

import datetime
import os
import sys
import tempfile
import time

TIMEOUT_S = 600


def _rank(rank: int, n: int, init_method: str, queue) -> None:
    import torch

    from x3d_tpu_torch import parallel, variant_config
    from x3d_tpu_torch.models import create_model
    from x3d_tpu_torch.train import (MultigridSchedule, create_train_state,
                                     make_eval_step, make_train_step)
    from x3d_tpu_torch.train.loop import evaluate

    torch.set_num_threads(1)
    model_ax = 2 if (n % 2 == 0 and n >= 4) else 1
    mesh = parallel.init_mesh(n // model_ax, model_ax, rank=rank,
                              world_size=n, init_method=init_method,
                              device="cpu",
                              timeout=datetime.timedelta(seconds=TIMEOUT_S))
    gen = torch.Generator().manual_seed(0)
    cfg = variant_config("M")
    net = create_model(cfg, dtype=torch.float32, device="cpu", mesh=mesh)
    batch_size = 2 * n                 # 2 clips a rank, 4x32^2
    video = torch.randn((batch_size, 4, 32, 32, 3), generator=gen)
    label = torch.arange(batch_size) % cfg.NETWORK.NUM_CLASSES
    batch = parallel.shard_batch({"video": video, "label": label}, mesh)

    state = create_train_state(cfg, net, steps_per_epoch=100)
    train_step = make_train_step(net, cfg.NETWORK.WEIGHT_DECAY)
    state, metrics = train_step(state, batch, gen)
    loss = float(metrics["loss"])
    assert torch.isfinite(metrics["loss"]), f"non-finite loss {loss}"
    assert state.step == 1
    weights = parallel.full_model_state(net)

    # one eval step: n videos x 2 views, each data rank its videos
    views = 2
    eval_cfg = variant_config("M")
    eval_cfg.TEST.NUM_TEMPORAL_VIEWS = views
    eval_cfg.TEST.NUM_SPATIAL_CROPS = 1
    eval_net = create_model(eval_cfg, dtype=torch.float32, device="cpu",
                            init=False, mesh=mesh)
    eval_net.load_state_dict(weights)
    ebatch = parallel.shard_batch(
        {"video": torch.randn((n * views, 4, 32, 32, 3), generator=gen),
         "label": torch.arange(n) % cfg.NETWORK.NUM_CLASSES}, mesh,
        clips_per_sample=views)
    sums = evaluate(make_eval_step(eval_net),
                    create_train_state(eval_cfg, eval_net, steps_per_epoch=1),
                    [ebatch])
    assert sums["count"] == n, sums

    # per-replica BN (TPU.SYNC_BN: False): each rank's batch one group
    grouped_cfg = variant_config("M")
    grouped_cfg.TPU.SYNC_BN = False
    grouped = create_model(grouped_cfg, dtype=torch.float32, device="cpu",
                           init=False, mesh=mesh)
    grouped.load_state_dict(weights)
    g_state = create_train_state(grouped_cfg, grouped, steps_per_epoch=100)
    _, g_metrics = make_train_step(grouped, cfg.NETWORK.WEIGHT_DECAY)(
        g_state, batch, gen)
    loss_grp = float(g_metrics["loss"])
    assert torch.isfinite(g_metrics["loss"]), f"grouped loss {loss_grp}"

    # one multigrid coarse-phase step (8x the batch, the coarse clip
    # shape), a data rank's share of the phase's batch
    mg_cfg = variant_config("M")
    mg_cfg.DATA.TEMP_DURATION = 4
    mg_cfg.DATA.TRAIN_CROP_SIZE = 32
    mg_cfg.DATA.TRAIN_JITTER_SCALES = [36, 44]
    mg_cfg.TRAIN.BATCH_SIZE = batch_size
    mg_cfg.MULTIGRID.SPATIAL_DIVISOR = 4
    sched = MultigridSchedule(mg_cfg, base_steps_per_epoch=8, epochs=4)
    coarse = sched.phases[0]
    assert coarse.batch_size == 8 * batch_size, sched.describe()
    cbatch = parallel.shard_batch(
        {"video": torch.randn((coarse.batch_size, coarse.temp_duration,
                               coarse.crop_size, coarse.crop_size, 3),
                              generator=gen),
         "label": torch.arange(coarse.batch_size)
         % cfg.NETWORK.NUM_CLASSES}, mesh)
    mg_net = create_model(mg_cfg, dtype=torch.float32, device="cpu",
                          init=False, mesh=mesh)
    mg_net.load_state_dict(weights)
    mg_state = create_train_state(mg_cfg, mg_net,
                                  schedule=sched.make_lr_schedule())
    _, mg_metrics = make_train_step(mg_net, cfg.NETWORK.WEIGHT_DECAY)(
        mg_state, cbatch, gen)
    loss_mg = float(mg_metrics["loss"])
    assert torch.isfinite(mg_metrics["loss"]), f"multigrid loss {loss_mg}"

    if mesh.is_main:
        queue.put(f"dryrun_multigpu OK: mesh={mesh.shape} "
                  f"train loss={loss:.4f} eval videos={int(sums['count'])} "
                  f"grouped_bn loss={loss_grp:.4f} multigrid coarse "
                  f"({coarse.batch_size}x{coarse.temp_duration}x"
                  f"{coarse.crop_size}^2) loss={loss_mg:.4f}")
    parallel.barrier(mesh)
    parallel.shutdown()


def dryrun_multigpu(n: int = 2) -> None:
    """Run the dry run on ``n`` gloo ranks (processes) and print rank 0's
    line; raises where a rank fails or the run takes over TIMEOUT_S."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    with tempfile.TemporaryDirectory(prefix="x3d_dryrun_") as d:
        init = "file://" + os.path.join(d, "rendezvous")
        procs = [ctx.Process(target=_rank, args=(r, n, init, queue))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + TIMEOUT_S
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs) \
                        or time.monotonic() > deadline:
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * n:
        raise RuntimeError(f"dryrun_multigpu({n}): the ranks exited with "
                           f"{codes}")
    print(queue.get(), flush=True)


if __name__ == "__main__":
    dryrun_multigpu(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
