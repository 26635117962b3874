"""Prediction CLI: serve a trained checkpoint over synthetic clips.

    python -m x3d_tpu_torch.tools.predict --cfg=... \
        --model_folder=/tmp/x3d_s --synthetic --max_batches=1

Emits one JSON line per video: {"label": ..., "top": [...], "probs": [...]}.
Flags kept verbatim from the JAX package's ``tools/predict.py``: cfg,
model_folder, file_pattern, synthetic, max_batches, batch_videos, k, opts.
Added: ``--device`` (cuda by default).  A real ``--file_pattern`` waits for
the input pipeline (ROADMAP A8).
"""

from __future__ import annotations

import argparse
import json
import logging


def build_parser() -> argparse.ArgumentParser:
    from x3d_tpu_torch.tools.common import add_bool_flag, add_common_flags

    p = argparse.ArgumentParser(
        prog="x3d_tpu_torch.tools.predict",
        description="Top-k predictions from an X3D checkpoint.")
    p.add_argument("--cfg", required=True, help="Config yaml.")
    p.add_argument("--model_folder", required=True,
                   help="Train-CLI output directory.")
    p.add_argument("--file_pattern", default=None,
                   help="TFRecord pattern (eval protocol).")
    add_bool_flag(p, "synthetic", False, "Predict on random clips (smoke).")
    p.add_argument("--max_batches", type=int, default=None,
                   help="Cap batches.")
    p.add_argument("--batch_videos", type=int, default=4,
                   help="Videos per request.")
    p.add_argument("--k", type=int, default=5, help="Top-k to report.")
    add_common_flags(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    import numpy as np

    from x3d_tpu_torch.serving import InferenceEngine
    from x3d_tpu_torch.tools.common import flat_opts, load_config

    cfg = load_config(args.cfg, flat_opts(args.opts))
    if not args.synthetic:
        raise NotImplementedError(
            "--file_pattern: real input data is not ported yet (ROADMAP "
            "A8); pass --synthetic")
    engine = InferenceEngine.from_checkpoint(
        cfg, args.model_folder, max_videos=args.batch_videos,
        device=args.device)

    rng = np.random.RandomState(0)
    for _ in range(args.max_batches or 2):
        video = rng.randint(0, 255, engine.clip_shape).astype(np.uint8)
        idx, p = engine.top_k(video, k=args.k)
        for top, probs in zip(idx, p):
            print(json.dumps({
                "label": -1,
                "top": [int(t) for t in top],
                "probs": [round(float(x), 5) for x in probs],
            }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
