"""Serving-latency benchmark: per-request time through InferenceEngine.

Serving a video-classification model is latency-shaped: one video arrives,
its view ensemble (10 clips for XS/S/M, 3 for L/XL) must come back inside
an SLO.  This tool measures that per variant at request sizes of 1..N
videos and prints one JSON line per combination, with two numbers:

* ``device_ms``: CUDA events around back-to-back requests at full capacity
  (``InferenceEngine.device_latency_s``): the card's work and any gap the
  host leaves between launches;
* ``wall_ms``: median host wall-clock through ``predict``, upload and
  result fetch included.

    python -m x3d_tpu_torch.tools.bench_serving --variants=S,M --videos=1,8

Runs on the card; without one it raises (the device time is a CUDA-event
time and has no CPU counterpart).
"""

from __future__ import annotations

import argparse
import json


def bench_one(variant: str, n_videos: int, iters: int, wall_samples: int,
              device=None) -> dict:
    from x3d_tpu_torch import variant_config
    from x3d_tpu_torch.serving import InferenceEngine
    from x3d_tpu_torch.tools.trace import card

    cfg = variant_config(variant)
    engine = InferenceEngine.random_init(cfg, max_videos=n_videos,
                                         device=device)
    device_s = engine.device_latency_s(iters=iters)
    wall_s = engine.wall_latency_s(samples=wall_samples)
    views = engine.views
    return {
        "card": card(),
        "variant": variant,
        "videos": n_videos,
        "views": views,
        "clips": n_videos * views,
        "input": (f"{n_videos * views}x{cfg.DATA.TEMP_DURATION}"
                  f"x{cfg.DATA.TEST_CROP_SIZE}^2"),
        "device_ms": round(device_s * 1e3, 2),
        "wall_ms": round(wall_s * 1e3, 2),
        "device_clips_per_sec": round(n_videos * views / device_s, 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="XS,S,M,L,XL",
                    help="Comma-separated variant names.")
    ap.add_argument("--videos", default="1,4", help="Request sizes in videos.")
    ap.add_argument("--iters", type=int, default=8,
                    help="Timed back-to-back requests.")
    ap.add_argument("--wall_samples", type=int, default=20,
                    help="Wall-clock sample count.")
    args = ap.parse_args(argv)
    for v in [s.strip().upper() for s in args.variants.split(",")]:
        for n in [int(s) for s in args.videos.split(",")]:
            print(json.dumps(bench_one(v, n, args.iters, args.wall_samples)),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
