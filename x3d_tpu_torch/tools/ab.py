"""Full-train-step A/B harness on the card.

The counterpart of the JAX package's ``tools/ab.py``: it times the complete
X3D train step (or the view-ensemble eval forward) under a chosen
combination of knobs, the one measurement that shows whether a kernel
change moves the step.

    python -m x3d_tpu_torch.tools.ab --impl=kernels [--variant=M]
        [--batch=128] [--steps=20] [--remat=block] [--crop=224] [--fold=on]
        [--bn_groups=2] [--mode=eval] [--device=cpu]

  --impl:      kernels (the hand-written CUDA kernels, the default) | plain
               (their plain PyTorch versions, ``ops.plain_versions()``).
               The JAX tool's --dw and --pw name TPU lowerings that the
               port does not have: given with a value, they are a usage
               error (exit 2).
  --remat:     auto | off | block | stage | convs  (models/x3d.py)
  --fold:      config | auto | on | off  (the time-folded layout)
  --bn_groups: per-replica BN statistics over this many slices of the
               batch (1 = one group)
  --mode:      train (default, full step) | eval (view-ensemble forward at
               the variant's test protocol; --batch then counts VIDEOS)

Prints one JSON line with the JAX tool's ``step_ms`` and ``clips_per_s``
(the best of 3 timed rounds of --steps chained steps after one warm-up
step, each round ended by ``torch.cuda.synchronize()`` on the card), and
the card's name and power limit.  bfloat16, random weights and a synthetic
batch from seed 0.  Runs on the card and raises without one unless
``--device cpu`` is passed (then the numbers are the CPU's and say nothing
about the card).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch

IMPLS = ("kernels", "plain")


def run_ab(variant: str, impl: str, batch: int, steps: int,
           remat: str = "auto", crop: int | None = None,
           fold: str = "config", mode: str = "train",
           temp: int | None = None, bn_groups: int = 1, device=None, *,
           cfg=None, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Time ``steps`` chained steps of X3D-``variant`` (``cfg``, if given,
    in place of the variant's config) at ``batch`` clips (eval: videos) in
    3 rounds after one warm-up step; returns the JAX tool's row with
    ``impl`` and ``bn_groups`` in place of its ``dw`` and ``pw``."""
    from x3d_tpu_torch import ops, variant_config
    from x3d_tpu_torch.data import synthetic_batches
    from x3d_tpu_torch.models import create_model
    from x3d_tpu_torch.tools.common import fold_flag, remat_flag
    from x3d_tpu_torch.train import (create_train_state, make_eval_step,
                                     make_train_step)
    from x3d_tpu_torch.utils import resolve_device

    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} is not one of {IMPLS}")
    device = resolve_device(device)
    cfg = (variant_config(variant) if cfg is None else cfg).clone()
    cfg.defrost()
    if crop:
        # override whichever geometry this mode actually benchmarks
        cfg.DATA.TRAIN_CROP_SIZE = crop
        cfg.DATA.TEST_CROP_SIZE = crop
    if temp:
        cfg.DATA.TEMP_DURATION = temp     # multigrid phase geometries
    model = create_model(cfg, dtype=dtype, device=device,
                         remat=remat_flag(remat), bn_groups=bn_groups,
                         time_fold=fold_flag(fold))
    state = create_train_state(cfg, model, steps_per_epoch=1000)
    T = cfg.DATA.TEMP_DURATION
    train = mode == "train"
    S = cfg.DATA.TRAIN_CROP_SIZE if train else cfg.DATA.TEST_CROP_SIZE
    data = next(synthetic_batches(cfg, batch, is_training=train,
                                  dtype=dtype, device=device))
    if train:
        train_step = make_train_step(model, cfg.NETWORK.WEIGHT_DECAY)
        gen = torch.Generator(device=device).manual_seed(0)

        def step():
            nonlocal state
            state, metrics = train_step(state, data, gen)
            return metrics["loss"]
    else:
        eval_step = make_eval_step(model)

        def step():
            return eval_step(state, data)["loss_sum"]

    def done(out):
        if device.type == "cuda":
            torch.cuda.synchronize()
        float(out)

    best = float("inf")
    with ops.plain_versions() if impl == "plain" \
            else contextlib.nullcontext():
        done(step())
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(steps):
                out = step()
            done(out)
            best = min(best, (time.perf_counter() - t0) / steps)
    clips = data["video"].shape[0]
    common = {"fold": str(fold), "input": f"{T}x{S}^2",
              "step_ms": best * 1e3, "clips_per_s": clips / best}
    if not train:
        views = clips // batch
        return {"variant": variant, "mode": "eval", "impl": impl,
                "videos": batch, "views": views, "clips": clips, **common}
    return {"variant": variant, "impl": impl, "batch": batch,
            "remat": model.remat, "bn_groups": bn_groups, **common}


def main(argv=None) -> int:
    from x3d_tpu_torch.tools.trace import card
    from x3d_tpu_torch.utils import use_deterministic_cudnn

    ap = argparse.ArgumentParser(prog="x3d_tpu_torch.tools.ab",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--variant", default="M", help="X3D variant.")
    ap.add_argument("--impl", default="kernels", choices=IMPLS,
                    help="The kernels or their plain versions.")
    ap.add_argument("--dw", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--pw", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--batch", type=int, default=128,
                    help="Train batch (clips); eval: videos.")
    ap.add_argument("--steps", type=int, default=20,
                    help="Chained steps per timed round.")
    ap.add_argument("--remat", default="auto",
                    help="Remat mode: auto/off/block/stage/convs.")
    ap.add_argument("--crop", type=int, default=0,
                    help="Override the crop size (0 = config).")
    ap.add_argument("--temp", type=int, default=0,
                    help="Override TEMP_DURATION (0 = config; multigrid "
                         "phase geometries).")
    ap.add_argument("--fold", default="config",
                    choices=["config", "auto", "on", "true", "off", "false"],
                    help="Time-folded layout: config/auto/on/off.")
    ap.add_argument("--mode", default="train", choices=["train", "eval"],
                    help="train (full step) or eval (view-ensemble forward; "
                         "--batch counts videos).")
    ap.add_argument("--bn_groups", type=int, default=1,
                    help="Per-replica BN groups in the batch.")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu.")
    args = ap.parse_args(argv)
    for flag in ("dw", "pw"):
        if getattr(args, flag) is not None:
            ap.error(f"--{flag}={getattr(args, flag)} names a TPU lowering "
                     "that the port does not have; its knob is "
                     "--impl kernels|plain (with --remat, --fold, "
                     "--bn_groups)")
    use_deterministic_cudnn()
    row = run_ab(args.variant.upper(), args.impl, args.batch, args.steps,
                 args.remat, args.crop or None, args.fold, args.mode,
                 args.temp or None, args.bn_groups, args.device)
    if torch.device(args.device or "cuda").type == "cuda":
        row["card"] = card()
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
