"""Device memory of a train or eval step, measured on the card.

The counterpart of the JAX package's ``tools/memory.py``, the tool that
says whether a (variant, batch, remat) combination fits a card before a
run is spent on it.  XLA reports a compiled step's buffers without running
it; PyTorch has no such accounting, so this tool runs one real step on
the card, at the config's geometry in bfloat16, after a warm-up step (which
creates the optimizer's momentum and the library's workspaces):

* ``args_gb``: what is allocated once the model, the optimizer state and
  the batch exist (the warm-up step's gradients released);
* ``total_gb``: ``torch.cuda.max_memory_allocated()`` over the step, after
  ``reset_peak_memory_stats`` (the caching allocator's blocks, rounding and
  library workspaces included: a peak of this card's allocator, not XLA's
  figure);
* ``temp_gb`` = total - args; ``out_gb``: what the step leaves allocated
  beyond args (its gradients and metrics).

Each counts only what the tool allocated itself.  One JSON line per
``--batch``, with the JAX tool's keys; ``fits`` compares ``total_gb`` with
``--hbm_gb`` (by default the card's own memory).  Everything is freed
between batches.  There is no CPU fallback: without a card it raises.

    python -m x3d_tpu_torch.tools.memory \\
        --config=x3d_tpu_torch/configs/kinetics/X3D_L.yaml \\
        --batch=16 [--batch=24 ...] [--mode=train] [--remat=off] [--fold=off]
"""

from __future__ import annotations

import argparse
import gc
import json

import torch

GB = 1e9


def measure(cfg, batch: int, mode: str, remat, fold) -> dict:
    """Run a warm-up step and one measured step on the card: bytes of
    ``args``, ``total`` (the step's peak) and ``out``, and the remat mode
    the model resolved."""
    if not torch.cuda.is_available():
        raise RuntimeError("tools.memory measures the card's allocator over "
                           "a real step: no CUDA device is available, and "
                           "there is no CPU fallback")
    from x3d_tpu_torch.data import synthetic_batches
    from x3d_tpu_torch.models import create_model
    from x3d_tpu_torch.train import (create_train_state, make_eval_step,
                                     make_train_step)

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    train = mode == "train"
    model = create_model(cfg, dtype=torch.bfloat16, remat=remat,
                         time_fold=fold)
    state = create_train_state(cfg, model, steps_per_epoch=1000)
    data = next(synthetic_batches(cfg, batch, is_training=train))
    if train:
        train_step = make_train_step(model, cfg.NETWORK.WEIGHT_DECAY)
        gen = torch.Generator(device="cuda").manual_seed(0)

        def step():
            return train_step(state, data, gen)[1]
    else:
        eval_step = make_eval_step(model)

        def step():
            return eval_step(state, data)

    out = step()
    state.optimizer.zero_grad(set_to_none=True)
    del out
    torch.cuda.synchronize()
    args = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    out = step()
    torch.cuda.synchronize()
    got = {"args": args,
           "total": torch.cuda.max_memory_allocated() - base,
           "out": torch.cuda.memory_allocated() - base - args,
           "remat": model.remat}
    del out, step, state, model, data
    gc.collect()
    torch.cuda.empty_cache()
    return got


def analyze(cfg, batch: int, mode: str, remat, fold=None) -> dict:
    """One row of the JAX tool's keys (but ``fits``) for ``batch`` clips
    (eval: videos of the config's views) in ``mode``; ``remat`` as
    ``create_model`` takes it (None: the config's), reported resolved."""
    T = cfg.DATA.TEMP_DURATION
    S = (cfg.DATA.TRAIN_CROP_SIZE if mode == "train"
         else cfg.DATA.TEST_CROP_SIZE)
    views = (1 if mode == "train"
             else cfg.TEST.NUM_TEMPORAL_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS)
    m = measure(cfg, batch, mode, remat, fold)
    return {
        "batch": batch,
        "remat": str(m["remat"]),
        "fold": str(fold),
        "input": f"{batch * views}x{T}x{S}^2",
        "temp_gb": round((m["total"] - m["args"]) / GB, 3),
        "args_gb": round(m["args"] / GB, 3),
        "out_gb": round(m["out"] / GB, 3),
        "total_gb": round(m["total"] / GB, 3),
    }


def main(argv=None) -> int:
    from x3d_tpu_torch.tools.common import fold_flag, load_config, remat_flag
    from x3d_tpu_torch.tools.trace import card

    ap = argparse.ArgumentParser(prog="x3d_tpu_torch.tools.memory",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True, help="Variant config yaml.")
    ap.add_argument("--batch", type=int, action="append",
                    help="Batch size(s) to analyze (repeatable; default 16).")
    ap.add_argument("--mode", default="train", choices=["train", "eval"],
                    help="train or eval.")
    ap.add_argument("--remat", default="auto",
                    help="Remat mode: auto/off/block/stage/convs.")
    ap.add_argument("--hbm_gb", type=float, default=None,
                    help="The card's memory for the verdict (default: the "
                         "card's own).")
    ap.add_argument("--fold", default="config",
                    choices=["config", "auto", "on", "true", "off", "false"],
                    help="Time-folded layout: config/auto/on/off.")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    remat, fold = remat_flag(args.remat), fold_flag(args.fold)
    hbm_gb = args.hbm_gb
    if hbm_gb is None:
        hbm_gb = torch.cuda.get_device_properties(0).total_memory / GB \
            if torch.cuda.is_available() else float("nan")
    name = card() if torch.cuda.is_available() else None
    for b in args.batch or [16]:
        r = analyze(cfg, b, args.mode, remat, fold)
        r["fits"] = r["total_gb"] <= hbm_gb
        if name:
            r["card"] = name
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
