"""Shard inspector, the counterpart of the JAX package's
``x3d_tpu/tools/inspect_tfrecords.py`` (reference
``datasets/inspect_tfrecord.py``): round-trip samples through the port's
reader and write watchable GIFs, ``sample<i>_label<label>.gif``.

    python -m x3d_tpu_torch.tools.inspect_tfrecords \
        --cfg=x3d_tpu_torch/configs/kinetics/X3D_M.yaml \
        --file_pattern='/data/train-*.tfrecord' --output_dir=/tmp/inspect

Same flags, plus ``--device`` and ``--opts`` as the other tools take them.
"""

from __future__ import annotations

import argparse
import logging

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    from x3d_tpu_torch.tools.common import add_bool_flag, add_common_flags

    p = argparse.ArgumentParser(
        prog="x3d_tpu_torch.tools.inspect_tfrecords",
        description="Write samples of TFRecord shards as GIFs.")
    p.add_argument("--cfg", required=True, help="Config yaml.")
    p.add_argument("--file_pattern", required=True, help="TFRecord pattern.")
    p.add_argument("--output_dir", required=True,
                   help="Where to write GIFs.")
    p.add_argument("--num_samples", type=int, default=4,
                   help="Samples to dump.")
    add_bool_flag(p, "training", True, "Use the training transform path.")
    add_common_flags(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from x3d_tpu_torch.data.tfrecords import inspect_tfrecords
    from x3d_tpu_torch.tools.common import flat_opts, load_config

    cfg = load_config(args.cfg, flat_opts(args.opts))
    paths = inspect_tfrecords(cfg, args.file_pattern, args.output_dir,
                              num_samples=args.num_samples,
                              is_training=args.training, device=args.device)
    for p in paths:
        log.info("wrote %s", p)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
