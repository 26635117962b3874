"""Serving-latency benchmark: per-request time through InferenceEngine.

Serving a video-classification model is latency-shaped: one video arrives,
its view ensemble (10 clips for XS/S/M, 3 for L/XL) must come back inside
an SLO.  This tool measures that per variant at request sizes of 1..N
videos, in the activation layouts ``--fold`` names (the engine's
``time_fold``), and prints one JSON line per combination, with the
engine's resolved layout and two numbers:

* ``device_ms``: CUDA events around back-to-back requests at full capacity
  (``InferenceEngine.device_latency_s``): the card's work and any gap the
  host leaves between launches;
* ``wall_ms``: median host wall-clock through ``predict``, upload and
  result fetch included.

    python -m x3d_tpu_torch.tools.bench_serving --variants=S,M --videos=1,8 \
        [--fold=off]

Runs on the card; without one it raises (the device time is a CUDA-event
time and has no CPU counterpart).
"""

from __future__ import annotations

import argparse
import json


# --fold: the engine's time_fold settings each name runs (None: the
# engine's own rule, a fold at <= 16 clips)
FOLDS = {"both": (False, True), "on": (True,), "off": (False,),
         "mixed": ("mixed",), "auto": (None,), "all": (False, True, "mixed")}


def bench_one(variant: str, n_videos: int, iters: int, wall_samples: int,
              device=None, fold=False) -> dict:
    from x3d_tpu_torch import variant_config
    from x3d_tpu_torch.serving import InferenceEngine
    from x3d_tpu_torch.tools.trace import card

    cfg = variant_config(variant)
    engine = InferenceEngine.random_init(cfg, max_videos=n_videos,
                                         device=device, time_fold=fold)
    device_s = engine.device_latency_s(iters=iters)
    wall_s = engine.wall_latency_s(samples=wall_samples)
    views = engine.views
    return {
        "card": card(),
        "variant": variant,
        "videos": n_videos,
        "views": views,
        "clips": n_videos * views,
        "fold": engine.layout,
        "input": (f"{n_videos * views}x{cfg.DATA.TEMP_DURATION}"
                  f"x{cfg.DATA.TEST_CROP_SIZE}^2"),
        "device_ms": round(device_s * 1e3, 2),
        "wall_ms": round(wall_s * 1e3, 2),
        "device_clips_per_sec": round(n_videos * views / device_s, 1),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="XS,S,M,L,XL",
                    help="Comma-separated variant names.")
    ap.add_argument("--videos", default="1,4", help="Request sizes in videos.")
    ap.add_argument("--iters", type=int, default=8,
                    help="Timed back-to-back requests.")
    ap.add_argument("--wall_samples", type=int, default=20,
                    help="Wall-clock sample count.")
    ap.add_argument("--fold", default="off", type=str.lower,
                    choices=list(FOLDS),
                    help="Layouts: both/on/off/mixed/all (unfolded, "
                         "time-folded, the first two stages folded), or "
                         "auto (the engine's rule: fold at <= 16 clips). "
                         "The port runs one program for every layout, so "
                         "more than one repeats a row.")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for v in [s.strip().upper() for s in args.variants.split(",")]:
        for n in [int(s) for s in args.videos.split(",")]:
            for fold in FOLDS[args.fold]:
                print(json.dumps(bench_one(v, n, args.iters,
                                           args.wall_samples, fold=fold)),
                      flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
