"""Where an X3D training step's time goes on the card.

Builds the model (random weights from a seed), its SGD-Nesterov state and
a synthetic batch with cuDNN's flags as the train tool sets them
(deterministic algorithms), runs two warm-up steps, then traces a few
steps with ``torch.profiler`` (device activity only) and prints one JSON
line: the step's device busy time, the device's idle share between the
first and last kernel, device time per step for each of the port's
kernels (K1-K8, with their second passes) and for the library's kernel
families (GEMMs, cuDNN convs, elementwise, reductions, copies), the top
kernels by name, and by the step's spans (``train.step`` around
``train.forward``, ``train.backward``, ``train.reduce`` on a mesh,
``train.optimizer``) the host ms a step inside each
(``span_host_ms_per_step``) and the device's idle ms while each is the
innermost span open (``span_idle_ms_per_step``; "outside spans" between
steps), the spans mapped onto the trace by anchors at both ends of the
window (``clock_drift_ppm``, ``clock_error_us``).  Needs a CUDA card::

    python -m x3d_tpu_torch.tools.profile_training --variant M --clips 32

``--remat`` sets the remat mode ("off", "block", "stage", "convs"; the
default is the config's ``TPU.REMAT`` as ``create_model`` resolves it);
``--trace FILE`` also writes a Chrome trace, and the kernels' launch log
beside it (``launches.json``; ``tools/roofline`` reads a directory holding
``trace.json`` and that log).
"""

from __future__ import annotations

import argparse
import json

import torch

from x3d_tpu_torch import variant_config
from x3d_tpu_torch.data import synthetic_batches
from x3d_tpu_torch.models import create_model
from x3d_tpu_torch.tools.trace import card, port_group, trace
from x3d_tpu_torch.train import create_train_state, make_train_step
from x3d_tpu_torch.utils import use_deterministic_cudnn

# the kernel groups: the port's kernels by the names of their __global__
# functions (tools/trace.PORT_GROUPS), else the library's families
_group = port_group


def profile(cfg, clips: int, steps: int, seed: int,
            trace_path: str | None = None, remat=None) -> dict:
    use_deterministic_cudnn()           # as the train tool runs its steps
    model = create_model(cfg, seed=seed, remat=remat)
    state = create_train_state(cfg, model)
    train_step = make_train_step(model, cfg.NETWORK.WEIGHT_DECAY)
    batch = next(synthetic_batches(cfg, clips, seed=seed))
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def step():
        nonlocal state
        state, _ = train_step(state, batch, gen)

    return trace(step, steps, "step", group=port_group,
                 trace_path=trace_path)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", default="M")
    ap.add_argument("--clips", type=int, default=32)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, help="Chrome trace file")
    ap.add_argument("--remat", default=None,
                    choices=["off", "block", "stage", "convs"],
                    help="Remat mode (default: the config's TPU.REMAT).")
    args = ap.parse_args(argv)
    cfg = variant_config(args.variant)
    row = profile(cfg, args.clips, args.steps, args.seed, args.trace,
                  args.remat)
    print(json.dumps({"card": card(), "variant": args.variant,
                      "clips": args.clips, "remat": args.remat, **row}),
          flush=True)


if __name__ == "__main__":
    main()
