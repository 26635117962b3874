"""Where an X3D serving request's time goes on the card.

Traces a few requests of ``InferenceEngine`` (random weights from a seed)
with ``torch.profiler`` and prints one JSON line per request size: the
request's device time, the device's idle share between its first and last
kernel, device time by kernel family (the port's kernels, GEMMs, cuDNN
convs, elementwise, reductions, copies), the top kernels by name, and by
the engine's spans (``engine.request`` around ``engine.convert``,
``engine.upload``, ``engine.forward``, ``engine.fetch``) the host ms a
request inside each (``span_host_ms_per_request``) and the device's idle
ms while each is the innermost span open (``span_idle_ms_per_request``;
"outside spans" between requests), the spans mapped onto the trace by
anchors at both ends of the window (``clock_drift_ppm``,
``clock_error_us``), and beside them the kernel launches of one request
that apply a BatchNorm as their epilogue, by kernel and kind
(``epilogue_launches_per_request``, from the launch log).  Only device
activity is traced, which keeps the profiler's own host cost small; the
idle share still includes
each request's host work (copying the clips in, reading the
probabilities back), which the spans name.
Needs a CUDA card::

    python -m x3d_tpu_torch.tools.profile_serving --variant M --videos 1 8

``--trace DIR`` also writes each request size's window into a directory
of its own, ``DIR/<variant>_<n>video``: the Chrome trace ``trace.json``
and the kernels' launch log beside it (``tools/roofline`` reads both).
"""

from __future__ import annotations

import argparse
import collections
import json
import os

import numpy as np

from x3d_tpu_torch import ops, variant_config
from x3d_tpu_torch.serving import InferenceEngine
from x3d_tpu_torch.tools.trace import card, trace


def epilogue_launches(records) -> dict:
    """{kernel: {kind: launches}} of the launch records that apply a BN
    epilogue."""
    out = collections.defaultdict(collections.Counter)
    for r in records:
        if r["epilogue"] != "none":
            out[r["kernel"]][r["epilogue"]] += 1
    return {k: dict(v) for k, v in sorted(out.items())}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", default="M")
    ap.add_argument("--videos", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None,
                    help="directory for Chrome traces (one per size)")
    args = ap.parse_args(argv)

    cfg = variant_config(args.variant)
    name = card()
    base = InferenceEngine.random_init(cfg, max_videos=1, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    for n in args.videos:
        engine = base if n == 1 else InferenceEngine(cfg, base.model,
                                                     max_videos=n)
        clips = rng.integers(0, 256, (n * engine.views,)
                             + engine.clip_shape[1:], dtype=np.uint8)
        path = None
        if args.trace:
            where = os.path.join(args.trace, f"{args.variant}_{n}video")
            os.makedirs(where, exist_ok=True)
            path = os.path.join(where, "trace.json")
        row = trace(lambda: engine.predict(clips), args.requests,
                    "request", trace_path=path)
        with ops.launch_log() as log:
            engine.predict(clips)
        print(json.dumps({"card": name, "variant": args.variant,
                          "videos": n, "clips": n * engine.views, **row,
                          "epilogue_launches_per_request":
                              epilogue_launches(log)}),
              flush=True)


if __name__ == "__main__":
    main()
