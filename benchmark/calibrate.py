"""The readings that a cell's correctness limits are set from.

    python3 benchmark/calibrate.py --workload W --seeds 1 2 ... \
        --control_seeds 1 2 3 [--out FILE]

For each seed, the program's numbers against the reference (the lower
readings: sound runs of the program).  For each control seed, the same
numbers of the control (the reference in float8 e4m3 put in the program's
place), of a witness (the reference in bfloat16, the configuration's own
precision, computed apart from the program) and of the faults.  Training:
the reference on the first half of the batch, the mean over it; one
block's depthwise conv 5% off in the forward (``FAULT_BLOCK``); the same
conv's kernel gradient halved; a 1e-6 nudge of the input (no fault: what
rounding alone moves); with more than one rank, rank 0's batch alone, the
exchange left out.  Serving: half the views; every video's answer given to
the next video; one video's answer given to another as well.  A step that
leaves the state unchanged reads 1 on ``change_gap`` and needs no run.
``--out`` also keeps each leaf's gap of every training reading.
Training readings take no window; a serving reading is the engine's
answer to each request of the pool.  The benchmark's own runs never run
this.  One chip; a cell of several ranks calibrates the reference's
readings only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import compare, harness, registry  # noqa: E402


FAULT_BLOCK = "stage4_block1"


def _nudge(seed):
    def plant(model):
        gen = torch.Generator(device=next(model.parameters()).device)
        gen.manual_seed(seed)

        def hook(module, args):
            x = args[0]
            return (x * (1 + 1e-6 * torch.randn(
                x.shape, generator=gen, device=x.device)),)
        model.conv_1.register_forward_pre_hook(hook)
    return plant


def _block_fwd(model):
    conv = getattr(model, FAULT_BLOCK).bottleneck.b
    conv.register_forward_hook(lambda m, args, out: out * 1.05)


def _block_dk(model):
    getattr(model, FAULT_BLOCK).bottleneck.b.kernel.register_hook(
        lambda g: g * 0.5)


def _rounded(gaps: dict) -> dict:
    return {k: {n: float(f"{v:.4g}") for n, v in g.items()}
            for k, g in gaps.items()}


def calibrate_train(cfgfile, traffic, seed, control, device, steps):
    out, leaves = {}, {}
    ref = harness.reference_train(cfgfile, traffic, seed, device, steps)

    m = harness.bn_momentum(cfgfile)

    def read(name, got):
        out[name] = compare.train_numbers(got, ref, m)
        leaves[name] = _rounded(compare.train_leaf_gaps(got, ref, m))

    if traffic.get("ranks", 1) == 1:
        prog = harness.TrainProgram(cfgfile, traffic, seed, device)
        record = prog.first_steps(steps)
        prog.free()
        read("program", record)
    if control:
        variants = [("control", {"low": "fp8"}), ("bf16", {"low": "bf16"}),
                    ("nudge", {"plant": _nudge(seed)}),
                    ("half", {"half": True}),
                    ("block_fwd", {"plant": _block_fwd}),
                    ("block_dk", {"plant": _block_dk})]
        if traffic.get("ranks", 1) > 1:
            variants.append(("rank0_only", {"ranks": [0]}))
        for name, kw in variants:
            read(name, harness.reference_train(cfgfile, traffic, seed,
                                               device, steps, **kw))
    return out, leaves


def calibrate_serve(cfgfile, traffic, seed, control, device):
    prog = harness.ServeProgram(cfgfile, traffic, seed, device)
    answers = [prog.call() for _ in prog.pool]
    pool = prog.pool
    prog.free()
    ref = harness.reference_serve(cfgfile, seed, pool, device)
    out = {"program": compare.serve_numbers(answers, ref)}
    if control:
        for name in ("fp8", "bf16"):
            got = harness.reference_serve(cfgfile, seed, pool, device,
                                          low=name)
            out["control" if name == "fp8" else name] = \
                compare.serve_numbers(got, ref)
        c = cfgfile["config"]
        views = c["TEST"]["NUM_TEMPORAL_VIEWS"] \
            * c["TEST"]["NUM_SPATIAL_CROPS"]
        half = [p[np.arange(p.shape[0]) % views < views // 2] for p in pool]
        cut = dict(c, TEST=dict(c["TEST"], NUM_TEMPORAL_VIEWS=views // 2,
                                NUM_SPATIAL_CROPS=1))
        got = harness.reference_serve(dict(cfgfile, config=cut), seed, half,
                                      device)
        out["half_views"] = compare.serve_numbers(got, ref)
        swapped = [np.roll(a, 1, axis=0) for a in answers]
        out["swapped_answers"] = compare.serve_numbers(swapped, ref)
        one = [np.concatenate([a[:1], a[:1], a[2:]]) for a in answers]
        out["one_answer_twice"] = compare.serve_numbers(one, ref)
    return out, {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control_seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    bench = registry.Bench(os.path.dirname(registry.HERE))
    cell = bench.workload(args.workload)
    cfgfile = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    device = torch.device("cuda", 0)
    from x3d_tpu_torch.kernels import _build
    _build.build_all()
    rows = []
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        t0 = time.perf_counter()
        control = seed in args.control_seeds
        if traffic["kind"] == "train":
            got, leaves = calibrate_train(cfgfile, traffic, seed, control,
                                          device,
                                          traffic.get("ref_steps", 3))
        else:
            got, leaves = calibrate_serve(cfgfile, traffic, seed, control,
                                          device)
        if seed not in args.seeds:
            got.pop("program", None)
            leaves.pop("program", None)
        row = {"seed": seed, "seconds": time.perf_counter() - t0, **got}
        print(json.dumps(row), flush=True)
        rows.append(dict(row, leaves=leaves))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload,
                       "card": torch.cuda.get_device_name(0), "rows": rows},
                      f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
