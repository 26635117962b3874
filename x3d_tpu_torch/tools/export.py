"""Export CLI: a trained checkpoint -> ``.pt2`` programs (see
``x3d_tpu_torch/export.py``).

    python -m x3d_tpu_torch.tools.export \
        --cfg=x3d_tpu_torch/configs/kinetics/X3D_M.yaml \
        --model_folder=/tmp/x3d_m --export_dir=/tmp/x3d_m/export

Restores the latest checkpoint written by the train CLI under
``model_folder/checkpoints`` (as the eval CLI does) and writes
``serve_clips.pt2``, ``serve_videos.pt2`` and ``export.json``, whose
default signature, ``serve_videos``, is the variant's multi-view eval
protocol over raw uint8 clips; prints the export directory.  Without a
checkpoint it exits 2 unless ``--allow_random_init`` (weights drawn from
seed 0).

Flags kept from the JAX package's ``tools/export.py``: cfg, model_folder,
export_dir, opts, batch_clips (0: a dynamic batch), dtype (float32 |
bfloat16), allow_random_init.  Added: ``--device`` (where the programs are
traced and their state lives; cuda by default) and ``--portable`` (ATen
ops only: the plain versions instead of the ``x3d::`` kernel ops, for a
process without this package).  Not taken: ``--tflite`` (the flatbuffer
converter is TensorFlow's, which the card machine does not have) and
``--platforms`` (a ``.pt2`` is not lowered per backend: ``export.load``
moves a program to the device asked for).
"""

from __future__ import annotations

import argparse
import logging
import os

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    from x3d_tpu_torch.tools.common import add_bool_flag, add_common_flags

    p = argparse.ArgumentParser(
        prog="x3d_tpu_torch.tools.export",
        description="Export an X3D checkpoint as torch.export programs "
                    "(.pt2) over raw uint8 clips.",
        epilog="--tflite and --platforms of the JAX tool are not taken: "
               "TFLite conversion needs TensorFlow, and a .pt2 program is "
               "moved to its device when it is loaded.")
    p.add_argument("--cfg", required=True,
                   help="(Relative) path to config (.yaml) file.")
    p.add_argument("--model_folder", required=True,
                   help="Directory holding checkpoints (from the train CLI).")
    p.add_argument("--export_dir", required=True,
                   help="Output directory of the programs.")
    p.add_argument("--batch_clips", type=int, default=0,
                   help="Fix the clip-batch dimension (0 = dynamic batch).")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "bfloat16"),
                   help="Compute dtype inside the programs.")
    add_bool_flag(p, "allow_random_init", False,
                  "Export a randomly initialised model when no checkpoint "
                  "exists (smoke tests only).")
    add_bool_flag(p, "portable", False,
                  "Trace the kernels' plain versions: ATen ops only, "
                  "loadable without x3d_tpu_torch.")
    add_common_flags(p)
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    import torch

    from x3d_tpu_torch.export import export_program
    from x3d_tpu_torch.models import create_model
    from x3d_tpu_torch.serving import restore_model
    from x3d_tpu_torch.tools.common import flat_opts, load_config
    from x3d_tpu_torch.train.checkpoint import CheckpointManager
    from x3d_tpu_torch.utils import resolve_device

    cfg = load_config(args.cfg, flat_opts(args.opts))
    ckpt_dir = os.path.join(args.model_folder, "checkpoints")
    have_ckpt = os.path.isdir(ckpt_dir) and \
        CheckpointManager(ckpt_dir, max_to_keep=0).latest_epoch() is not None
    if not have_ckpt and not args.allow_random_init:
        parser.error(f"No checkpoint found in {ckpt_dir}; pass "
                     "--allow_random_init to export an untrained model.")
    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    if have_ckpt:
        model = restore_model(cfg, args.model_folder, dtype, device)
    else:
        log.warning("No checkpoint in %s -- exporting RANDOM INIT "
                    "(--allow_random_init).", ckpt_dir)
        model = create_model(cfg, dtype=dtype, device=device, seed=0)
    out = export_program(cfg, model, args.export_dir, dtype=dtype,
                         batch_clips=args.batch_clips or None,
                         portable=args.portable, device=device)
    log.info("programs written to %s", out)
    print(out, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
