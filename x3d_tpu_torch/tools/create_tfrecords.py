"""Shard-writer tool, the counterpart of the JAX package's
``x3d_tpu/tools/create_tfrecords.py`` (reference
``datasets/create_tfrecords.py``), with the same flags and ``--device``:

    python -m x3d_tpu_torch.tools.create_tfrecords \
        --label_file=train.txt --output_dir=/data/tfrecords --prefix=train

Each video of the label file is decoded (an MJPEG AVI on the device, other
files by the host's video backend), trimmed to its first 10 seconds at the
container's frame rate (``--fps`` where the container gives none),
re-encoded at JPEG quality 90 (nvJPEG on the card, Pillow with ``--device
cpu``) and written, ``--videos_per_record`` videos a GZIP shard named
``<prefix>-00000.tfrecord``, ...  Workers are threads on the card and
processes on the CPU; the shards do not depend on them.
"""

from __future__ import annotations

import argparse
import logging

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="x3d_tpu_torch.tools.create_tfrecords",
        description="Write the videos of a label file into TFRecord "
                    "shards.")
    p.add_argument("--label_file", required=True,
                   help='Text file of "<video path> <label>" lines.')
    p.add_argument("--output_dir", required=True,
                   help="Directory for TFRecord shards.")
    p.add_argument("--prefix", default="train", help="Shard filename prefix.")
    p.add_argument("--videos_per_record", type=int, default=32,
                   help="Videos per shard.")
    p.add_argument("--num_workers", type=int, default=0,
                   help="Workers (0 = cpu_count-1).")
    p.add_argument("--fps", type=int, default=25,
                   help="Frame rate for the first-10s trim where the "
                        "container gives none.")
    p.add_argument("--device", default=None, help="cuda (the default) or "
                                                  "cpu.")
    return p


def read_label_file(path: str):
    """(path, label) pairs of a label file, as the JAX tool reads them:
    the label after the last space."""
    pairs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            video, label = line.rsplit(" ", 1)
            pairs.append((video, int(label)))
    return pairs


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from x3d_tpu_torch.data.tfrecords import create_tfrecords

    shards = create_tfrecords(
        read_label_file(args.label_file), args.output_dir,
        prefix=args.prefix, videos_per_record=args.videos_per_record,
        num_workers=args.num_workers or None, fps_default=args.fps,
        device=args.device)
    log.info("wrote %d shards", len(shards))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
