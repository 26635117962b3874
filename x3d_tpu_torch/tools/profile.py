"""Profile a train or eval step on the card and print a kernel breakdown.

The counterpart of the JAX package's ``tools/profile.py``: it traces N
steps with ``torch.profiler`` (through ``tools/trace.trace``, after two
warm-up steps, device activity only), writes the window into
``--trace_dir`` -- the Chrome trace ``trace.json``, the kernels' launch
log ``launches.json`` and the card's name in ``card.txt``, which
``tools/roofline`` reads too -- and prints :func:`analyze_trace`: device
time by kernel family and group (the JAX tool's HLO categories), and by
conv shape and direction, which the launch log gives each of the port's
kernels (the JAX tool reads them from XLA's conv dimensions).

    python -m x3d_tpu_torch.tools.profile \\
        --config=x3d_tpu_torch/configs/kinetics/X3D_M.yaml \\
        --mode=train --batch=16 --steps=3 [--trace_dir=DIR]
    python -m x3d_tpu_torch.tools.profile --analyze_only=DIR

Eval batches are ``batch`` videos of the config's views.  The capture
needs a CUDA card; ``--analyze_only`` reads a trace without one.
"""

from __future__ import annotations

import argparse
import collections
import os
import tempfile

from x3d_tpu_torch.tools import roofline
from x3d_tpu_torch.tools.trace import family


def analyze_trace(trace_dir: str, top: int = 15) -> str:
    """Summarise the window in ``trace_dir``: device time by family and
    group, then the port's kernels by (group, conv shape, direction) --
    a launch's second pass counted with it -- whose rows sum to their
    group."""
    if not os.path.exists(os.path.join(trace_dir, "trace.json")):
        return "no trace found"
    dev = roofline.load_device_events(trace_dir)
    by_group = collections.Counter()
    by_conv = collections.Counter()
    for e in dev:
        a = e["args"]
        by_group[(family(e["name"]), a["hlo_category"])] += e["dur"]
        if "shape" in a:
            by_conv[(a["direction"], a["shape"], a["hlo_category"])] += \
                e["dur"]

    lines = ["=== device time by family and group (ms) ==="]
    for (fam, group), d in by_group.most_common():
        lines.append(f"{d / 1e3:9.2f}  {fam:14s}  {group}")
    lines.append("=== the port's kernels by conv shape (fwd/bwd) ===")
    for (direc, shape, group), d in by_conv.most_common(top):
        lines.append(f"{d / 1e3:9.2f}  {direc:3s}  {shape:20s}  [{group}]")
    return "\n".join(lines)


def capture(cfg, mode: str, batch: int, steps: int, trace_dir: str) -> None:
    """Trace ``steps`` train or eval steps of ``cfg``'s model (bfloat16,
    random weights and a synthetic batch from seed 0) into ``trace_dir``."""
    import torch

    from x3d_tpu_torch.data import synthetic_batches
    from x3d_tpu_torch.models import create_model
    from x3d_tpu_torch.tools.trace import port_group, trace
    from x3d_tpu_torch.train import (create_train_state, make_eval_step,
                                     make_train_step)
    from x3d_tpu_torch.utils import use_deterministic_cudnn

    use_deterministic_cudnn()           # as the train tool runs its steps
    model = create_model(cfg)
    state = create_train_state(cfg, model, steps_per_epoch=1000)
    # eval batches carry batch x views clips with per-video labels, as the
    # eval pipeline's: the model's view average needs whole videos
    data = next(synthetic_batches(cfg, batch, is_training=mode == "train"))
    if mode == "train":
        train_step = make_train_step(model, cfg.NETWORK.WEIGHT_DECAY)
        gen = torch.Generator(device="cuda").manual_seed(0)

        def step():
            nonlocal state
            state, _ = train_step(state, data, gen)
    else:
        eval_step = make_eval_step(model)

        def step():
            eval_step(state, data)

    os.makedirs(trace_dir, exist_ok=True)
    trace(step, steps, "step", group=port_group,
          trace_path=os.path.join(trace_dir, "trace.json"))


def main(argv=None) -> int:
    from x3d_tpu_torch.tools.common import load_config

    ap = argparse.ArgumentParser(prog="x3d_tpu_torch.tools.profile",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None,
                    help="Variant config yaml (for a capture).")
    ap.add_argument("--mode", default="train", choices=["train", "eval"],
                    help="train or eval step to profile.")
    ap.add_argument("--batch", type=int, default=16,
                    help="Batch size (clips; eval: videos).")
    ap.add_argument("--steps", type=int, default=3, help="Steps to capture.")
    ap.add_argument("--trace_dir",
                    default=os.path.join(tempfile.gettempdir(), "x3d_trace"),
                    help="Trace output dir.")
    ap.add_argument("--analyze_only", default=None,
                    help="Skip capture; analyse this trace dir.")
    args = ap.parse_args(argv)
    if args.analyze_only:
        print(analyze_trace(args.analyze_only))
        return 0
    if args.config is None:
        ap.error("--config is required for a capture")
    capture(load_config(args.config), args.mode, args.batch, args.steps,
            args.trace_dir)
    print(analyze_trace(args.trace_dir))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
