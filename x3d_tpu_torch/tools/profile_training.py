"""Where an X3D training step's time goes on the card.

Builds the model (random weights from a seed), its SGD-Nesterov state and
a synthetic batch with cuDNN's flags as the train tool sets them
(deterministic algorithms), runs two warm-up steps, then traces a few
steps with ``torch.profiler`` (device activity only) and prints one JSON
line: the step's device busy time, the device's idle share between the
first and last kernel, device time per step for each of the port's
kernels (K1-K8, with their second passes) and for the library's kernel
families (GEMMs, cuDNN convs, elementwise, reductions, copies), and the top
kernels by name.  Needs a CUDA card::

    python -m x3d_tpu_torch.tools.profile_training --variant M --clips 32

``--remat`` sets the remat mode ("off", "block", "stage", "convs"; the
default is the config's ``TPU.REMAT`` as ``create_model`` resolves it);
``--trace FILE`` also writes a Chrome trace.
"""

from __future__ import annotations

import argparse
import json

import torch

from x3d_tpu_torch import variant_config
from x3d_tpu_torch.data import synthetic_batches
from x3d_tpu_torch.models import create_model
from x3d_tpu_torch.tools.trace import INPUT_KERNELS, card, family, trace
from x3d_tpu_torch.train import create_train_state, make_train_step
from x3d_tpu_torch.utils import use_deterministic_cudnn

# the port's kernels by the names of their __global__ functions
_PORT = (
    ("K1 depthwise_conv3d", ("dw_conv3d_fwd_kernel",
                             "dw_conv3d_fwd_temporal_kernel",
                             "dw_conv3d_fwd_ring_kernel")),
    ("K2 dw_bn_act_conv", ("dw_bn_act_conv_fwd_kernel",
                           "dw_bn_act_conv_fwd_ring_kernel",
                           "dw_bn_act_conv_fwd_sum_kernel")),
    ("K3 dw_bn_act_conv_bwd", ("dw_bn_act_conv_bwd_kernel",
                                "dw_bn_act_conv_bwd_ring_kernel",
                                "dw_bn_act_conv_bwd_sum_kernel")),
    ("K4 depthwise_conv3d_dx", ("dw_conv3d_dx_kernel",
                                "dw_conv3d_dx_phase_kernel")),
    ("K4 depthwise_conv3d_dk", ("dw_conv3d_dk_kernel",
                                "sum_dk_partials_kernel",
                                "dw_conv3d_dk_ring_kernel",
                                "dw_conv3d_dk_sum_kernel")),
    ("K5 pw_conv_stats", ("pw_conv_stats_mma_kernel",)),
    ("K6 pw_act_conv_stats", ("pw_act_conv_stats_mma_kernel",)),
    ("K5/K6 pw_stats", ("pw_stats_kernel",)),          # float32, odd K
    ("K7 pw_conv", ("pw_conv_kernel", "pw_conv_mma_kernel",
                    "pw_conv_wg_kernel")),
    ("K8 depthwise_conv3d_pbwd", ("dw_conv3d_pbwd_kernel",
                                  "sum_pbwd_partials_kernel",
                                  "dw_conv3d_pbwd_temporal_kernel",
                                  "dw_conv3d_pbwd_sum_kernel")),
    ("K2/K3/K5/K6 second passes", ("sum_partials_kernel",)),
    ("input", INPUT_KERNELS),
)


def _group(name: str) -> str:
    for group, keys in _PORT:
        if any(k in name for k in keys):
            return group
    return family(name)


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

    return trace(step, steps, "step", group=_group, trace_path=trace_path)


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
