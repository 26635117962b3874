"""Time the long-cycle multigrid phases' train steps on the card.

    python -m x3d_tpu_torch.tools.bench_multigrid [--variant=M] [--steps=10]

The counterpart of the JAX package's ``tools/bench_multigrid.py``.  For
each phase of the variant's MULTIGRID.LONG_CYCLE_FACTORS (default 8/4/2/1
batch multipliers) it times the full train step at the phase's (batch, T,
S) geometry the way the JAX package's ``tools/ab.run_ab`` does (the best of
3 timed rounds of ``--steps`` chained steps on one synthetic batch, after
one warm-up step; on the card each round ends with
``torch.cuda.synchronize()``), then reports the projected epoch-time
speedup of a multigrid data pass against the base shape:

    speedup = base_epoch_s / (sum over the cycle of phase epoch_s / phases)

each epoch being about one dataset pass at any phase (the schedule keeps
``batch * steps_per_epoch`` constant, ``train/multigrid.py``).

Prints one JSON line with the JAX tool's keys (``variant``,
``base_steps_per_epoch``, ``phases`` with ``phase``, ``batch``, ``input``,
``steps_per_epoch``, ``step_ms``, ``clips_per_s`` and ``epoch_s``, then
``base_epoch_s``, ``multigrid_mean_epoch_s`` and ``epoch_time_speedup``)
and the card's name and power limit.  It measures only the throughput term
of the method's gain, the part that depends on the hardware.  Runs on the
card and raises without one unless ``--device cpu`` is passed (then the
numbers are the plain versions' and say nothing about the card).
"""

from __future__ import annotations

import argparse
import json


def time_step(cfg, batch: int, steps: int, dtype, device) -> dict:
    """The best of 3 timed rounds of ``steps`` chained train steps at the
    config's geometry and ``batch`` clips (``tools/ab.run_ab``, as the JAX
    tool times a phase): ms a step and clips/s."""
    from x3d_tpu_torch.tools.ab import run_ab

    r = run_ab("", "kernels", batch, steps, device=device, cfg=cfg,
               dtype=dtype)
    return {"step_ms": r["step_ms"], "clips_per_s": r["clips_per_s"]}


def bench(cfg, variant: str, steps: int, base_steps_per_epoch: int,
          dtype, device) -> dict:
    import torch

    from x3d_tpu_torch.train.multigrid import MultigridSchedule

    sched = MultigridSchedule(cfg, base_steps_per_epoch,
                              epochs=len(cfg.MULTIGRID.LONG_CYCLE_FACTORS))
    phases = []
    cycle_time = 0.0
    for p in sched.phases:
        r = time_step(p.apply_to_config(cfg), p.batch_size, steps, dtype,
                      device)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        epoch_s = p.steps_per_epoch * r["step_ms"] / 1e3
        cycle_time += epoch_s
        phases.append({
            "phase": p.index, "batch": p.batch_size,
            "input": f"{p.temp_duration}x{p.crop_size}^2",
            "steps_per_epoch": p.steps_per_epoch,
            "step_ms": r["step_ms"],
            "clips_per_s": r["clips_per_s"],
            "epoch_s": epoch_s,
        })
    base_epoch_s = phases[-1]["epoch_s"]
    mean_epoch_s = cycle_time / len(phases)
    return {
        "variant": variant,
        "base_steps_per_epoch": base_steps_per_epoch,
        "phases": phases,
        "base_epoch_s": base_epoch_s,
        "multigrid_mean_epoch_s": mean_epoch_s,
        "epoch_time_speedup": base_epoch_s / mean_epoch_s,
    }


def main(argv=None) -> int:
    import torch

    from x3d_tpu_torch import variant_config
    from x3d_tpu_torch.tools.common import add_bool_flag
    from x3d_tpu_torch.tools.trace import card
    from x3d_tpu_torch.utils import resolve_device, use_deterministic_cudnn

    ap = argparse.ArgumentParser(prog="x3d_tpu_torch.tools.bench_multigrid",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--variant", default="M", help="X3D variant.")
    ap.add_argument("--steps", type=int, default=10,
                    help="Chained steps per timed round.")
    ap.add_argument("--base_steps_per_epoch", type=int, default=100,
                    help="Base steps/epoch used to weight the phases.")
    add_bool_flag(ap, "mixed_precision", True, "bfloat16 compute.")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu.")
    ap.add_argument("--opts", nargs="+", default=[],
                    help="Config overrides: KEY VALUE pairs.")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    use_deterministic_cudnn()
    variant = args.variant.upper()
    cfg = variant_config(variant)
    if args.opts:
        cfg.merge_from_list(args.opts)
    dtype = torch.bfloat16 if args.mixed_precision else torch.float32
    out = bench(cfg, variant, args.steps, args.base_steps_per_epoch, dtype,
                device)
    if device.type == "cuda":
        out["card"] = card()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
