"""Synthetic but real video corpus, the counterpart of the JAX package's
``x3d_tpu/tools/make_synthetic_videos.py``: the same formulas, seeds and
files.

Writes compressed mp4 files (OpenCV's ``VideoWriter``, libavcodec's mp4v)
in the class-per-folder layout that ``tools/create_label`` walks, so the
whole path -- create_label -> create_tfrecords -> train -> eval -- can be
driven through the tools with real decoding on the host.  OpenCV is
needed (the card machine has none): without it the tool raises and says
so.

Corpus design (the JAX tool's):
  * Classes are told apart by a background hue and by the direction of a
    moving block, so a short run reaches a high top-1.
  * Length (1.5-12 s; every 5th video forced past 10 s), frame rate
    (10-30 fps), aspect, brightness, block size and speed, and noise all
    vary: the writer's 10-second trim at the container's rate, the looping
    temporal sampler and non-square short-side resizes are exercised.
  * Each video is drawn from (seed, split, class, index), so a second run
    writes the same files, given the same codec build.

    python -m x3d_tpu_torch.tools.make_synthetic_videos \
        --output_root=/tmp/corpus

(defaults: 10 classes x (20 train + 4 val) = 240 videos).
"""

from __future__ import annotations

import argparse
import colorsys
import logging
import os

log = logging.getLogger(__name__)

# (width, height): landscape, portrait, square, wide, small
_SIZES = [(320, 240), (240, 320), (256, 256), (424, 240), (192, 144),
          (168, 224)]
_FPS = [10.0, 12.5, 15.0, 20.0, 24.0, 25.0, 30.0]


def class_name(k: int) -> str:
    return f"class_{k:02d}"


def _class_palette(k: int, num_classes: int):
    """Background hue and block color for class ``k`` (0-based)."""
    h = k / num_classes
    bg = colorsys.hsv_to_rgb(h, 0.85, 0.75)
    fg = colorsys.hsv_to_rgb((h + 0.5) % 1.0, 0.9, 1.0)
    to255 = lambda c: tuple(int(round(255 * x)) for x in c)  # noqa: E731
    return to255(bg), to255(fg)


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "make_synthetic_videos writes mp4 files through OpenCV "
            "(opencv-python), which is not installed") from e
    return cv2


def write_video(path: str, k: int, num_classes: int, rng,
                duration_range=(1.5, 12.0)) -> dict:
    """Write one mp4 for class ``k``; returns its metadata."""
    import numpy as np

    cv2 = _cv2()
    bg, fg = _class_palette(k, num_classes)
    width, height = _SIZES[rng.integers(len(_SIZES))]
    fps = float(_FPS[rng.integers(len(_FPS))])
    duration = float(rng.uniform(*duration_range))
    n = max(8, int(round(duration * fps)))

    # class-specific motion direction; speed/size/start vary per video
    angle = 2.0 * np.pi * k / num_classes + rng.uniform(-0.2, 0.2)
    speed = rng.uniform(0.01, 0.04) * min(width, height)  # px/frame
    side = int(rng.uniform(0.15, 0.3) * min(width, height))
    pos = np.array([rng.uniform(0, width), rng.uniform(0, height)])
    vel = speed * np.array([np.cos(angle), np.sin(angle)])
    brightness = rng.uniform(0.7, 1.2)
    noise_sigma = rng.uniform(0.0, 12.0)

    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (width, height))
    if not writer.isOpened():
        raise RuntimeError(f"cv2.VideoWriter failed to open {path}")
    base = np.clip(np.array(bg, np.float32) * brightness, 0, 255)
    for _ in range(n):
        frame = np.broadcast_to(base, (height, width, 3)).copy()
        if noise_sigma:
            frame += rng.normal(0.0, noise_sigma, frame.shape)
        x0, y0 = int(pos[0]) % width, int(pos[1]) % height
        frame[y0:y0 + side, x0:x0 + side] = fg  # clipped at the border
        pos += vel
        writer.write(np.clip(frame, 0, 255).astype(np.uint8)[..., ::-1])
    writer.release()
    return {"frames": n, "fps": fps, "size": (width, height),
            "duration_s": n / fps}


def generate(output_root: str, num_classes: int = 10,
             train_per_class: int = 20, val_per_class: int = 4,
             seed: int = 0, duration_range=(1.5, 12.0),
             force_over_10s: bool = True) -> dict:
    """Generate the corpus; returns summary stats."""
    import numpy as np

    _cv2()
    stats = {"videos": 0, "frames": 0, "bytes": 0, "over_10s": 0}
    for split, per_class in (("train", train_per_class),
                             ("val", val_per_class)):
        for k in range(num_classes):
            cdir = os.path.join(output_root, split, class_name(k))
            os.makedirs(cdir, exist_ok=True)
            for i in range(per_class):
                # deterministic per (seed, split, class, index)
                rng = np.random.default_rng(
                    [seed, 0 if split == "train" else 1, k, i])
                path = os.path.join(cdir, f"{class_name(k)}_{i:03d}.mp4")
                # a video past 10 s every 5th index, so the writer's trim
                # at the container's rate is exercised in both splits
                if force_over_10s and i % 5 == 4:
                    meta = None
                    while meta is None or meta["duration_s"] <= 10.0:
                        meta = write_video(path, k, num_classes, rng,
                                           duration_range)
                else:
                    meta = write_video(path, k, num_classes, rng,
                                       duration_range)
                stats["videos"] += 1
                stats["frames"] += meta["frames"]
                stats["bytes"] += os.path.getsize(path)
                stats["over_10s"] += meta["duration_s"] > 10.0
    return stats


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="x3d_tpu_torch.tools.make_synthetic_videos",
        description="Write a class-per-folder corpus of synthetic mp4s.")
    p.add_argument("--output_root", required=True,
                   help="Root directory; writes train/<class>/*.mp4 and "
                        "val/<class>/*.mp4 beneath it.")
    p.add_argument("--num_classes", type=int, default=10,
                   help="Number of classes.")
    p.add_argument("--train_per_class", type=int, default=20,
                   help="Training videos per class.")
    p.add_argument("--val_per_class", type=int, default=4,
                   help="Validation videos per class.")
    p.add_argument("--seed", type=int, default=0, help="Corpus seed.")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    stats = generate(args.output_root, args.num_classes,
                     args.train_per_class, args.val_per_class, args.seed)
    log.info("corpus at %s: %d videos (%d frames, %.1f MB, %d over 10 s)",
             args.output_root, stats["videos"], stats["frames"],
             stats["bytes"] / 1e6, stats["over_10s"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
