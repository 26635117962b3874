"""Label-file tool, the counterpart of the JAX package's
``x3d_tpu/tools/create_label.py`` (reference ``datasets/create_label.py``
and ``datasets/kinetics400/create_label.py``), with the same flags.

Class-per-folder tree (train/val layout):

    python -m x3d_tpu_torch.tools.create_label \
        --video_root=/data/kinetics/train --output=train.txt --sample_size=0

Flat Kinetics-400 test directory, labels resolved through the annotations
JSON and the Kinetics-400 label map (``x3d_tpu_torch/datasets/
kinetics400/``):

    python -m x3d_tpu_torch.tools.create_label \
        --video_root=/data/kinetics/test --output=test.txt \
        --test_json_file=/data/kinetics/test.json

Writes ``<video path> <label>`` lines, which ``tools/create_tfrecords``
turns into shards and ``tools/train --nouse_tfrecord`` and ``tools/eval
--notfrecord`` read as they are.
"""

from __future__ import annotations

import argparse
import json
import logging

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="x3d_tpu_torch.tools.create_label",
        description="Write a '<video path> <label>' list of a video tree.")
    p.add_argument("--video_root", required=True,
                   help="Root with one sub-directory per class (or a flat "
                        "directory when --test_json_file is given).")
    p.add_argument("--output", required=True, help="Output label-file path.")
    p.add_argument("--sample_size", type=int, default=0,
                   help="Cap videos per class (0 = unlimited).")
    p.add_argument("--path_to_label_map", default=None,
                   help="Class->id JSON (default: the Kinetics-400 label "
                        "map when --test_json_file is set, else the sorted "
                        "folder names).")
    p.add_argument("--test_json_file", default=None,
                   help="Kinetics test annotations JSON: treat --video_root "
                        "as a flat directory of <youtube_id>.<ext> videos.")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from x3d_tpu_torch.data.tfrecords import (create_label_file,
                                              create_test_label_file)

    label_map = None
    if args.path_to_label_map:
        with open(args.path_to_label_map) as f:
            label_map = json.load(f)
    if args.test_json_file:
        n = create_test_label_file(args.video_root, args.output,
                                   args.test_json_file, label_map=label_map)
    else:
        n = create_label_file(args.video_root, args.output,
                              label_map=label_map,
                              sample_size=args.sample_size or None)
    log.info("wrote %d lines to %s", n, args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
