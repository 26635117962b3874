"""Prediction CLI: serve a trained checkpoint over TFRecord or synthetic
clips.

    python -m x3d_tpu_torch.tools.predict --cfg=... \
        --model_folder=/tmp/x3d_s --file_pattern='/data/test-*'

Emits one JSON line per video: {"label": ..., "top": [...], "probs": [...]}.
Flags kept verbatim from the JAX package's ``tools/predict.py``: cfg,
model_folder, file_pattern, synthetic, max_batches, batch_videos, k, opts.
Added: ``--device`` (cuda by default).  ``--file_pattern`` names TFRecord
shards, read with the eval protocol (``data.InputReader`` as uint8 clips,
which the engine normalises), as the JAX tool reads them.
"""

from __future__ import annotations

import argparse
import itertools
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
    import torch

    from x3d_tpu_torch.data import InputReader
    from x3d_tpu_torch.serving import InferenceEngine
    from x3d_tpu_torch.tools.common import flat_opts, load_config

    cfg = load_config(args.cfg, flat_opts(args.opts))
    if not args.synthetic and not args.file_pattern:
        raise SystemExit("--file_pattern is required unless --synthetic")
    engine = InferenceEngine.from_checkpoint(
        cfg, args.model_folder, max_videos=args.batch_videos,
        device=args.device)

    if args.synthetic:
        rng = np.random.RandomState(0)
        batches = ({"video": rng.randint(0, 255, engine.clip_shape
                                         ).astype(np.uint8),
                    "label": [-1] * args.batch_videos}
                   for _ in range(args.max_batches or 2))
    else:
        reader = InputReader(cfg, is_training=False, device=engine.device,
                             dtype=torch.uint8)
        batches = reader(args.file_pattern, args.batch_videos)
        if args.max_batches:
            batches = itertools.islice(batches, args.max_batches)
    for batch in batches:
        idx, p = engine.top_k(batch["video"], k=args.k)
        for label, top, probs in zip(batch["label"], idx, p):
            print(json.dumps({
                "label": int(label),
                "top": [int(t) for t in top],
                "probs": [round(float(x), 5) for x in probs],
            }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
