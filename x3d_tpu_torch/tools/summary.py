"""Model summary tool: the counterpart of the JAX package's
``x3d_tpu/tools/summary.py`` (the analog of the reference's
``X3D.summary``).

Prints per-module parameter counts, BN-statistic counts and the activation
shape flowing out of every stage, from ``models/x3d.build_arch`` and the
shapes of the port model's ``state_dict`` (built on the ``meta`` device:
nothing is allocated or drawn), grouped under the Flax module names.  The
text equals the golden files ``model_summaries/X3D_{XS,S,M,L,XL}.txt``
byte for byte::

    python -m x3d_tpu_torch.tools.summary --variant=M
    python -m x3d_tpu_torch.tools.summary --all --output_dir=model_summaries
"""

from __future__ import annotations

import argparse
import io
import os
from collections import Counter

from x3d_tpu_torch.config import VARIANTS

_STATS = ("mean", "var")              # BN running statistics (buffers)


def summarize(variant: str) -> str:
    import torch

    from x3d_tpu_torch import variant_config
    from x3d_tpu_torch.models import build_arch, create_model

    cfg = variant_config(variant)
    arch = build_arch(cfg)
    model = create_model(cfg, dtype=torch.float32, device="meta")
    params, stats = Counter(), Counter()
    for key, t in model.state_dict().items():
        module, leaf = key.split(".")[0], key.rsplit(".", 1)[-1]
        (stats if leaf in _STATS else params)[module] += t.numel()
    T, S = cfg.DATA.TEMP_DURATION, cfg.DATA.TRAIN_CROP_SIZE

    out = io.StringIO()
    w = out.write
    w(f'Model: X3D-{variant}  (input 1 x {T} x {S} x {S} x 3, NDHWC)\n')
    w("=" * 78 + "\n")
    w(f'{"module":<28}{"output shape":<26}{"params":>12}{"bn stats":>12}\n')
    w("-" * 78 + "\n")

    t, h = T, S // 2
    w(f'{"conv_1 (stem)":<28}{str((1, t, h, h, arch.conv1_dim)):<26}'
      f'{params["conv_1"]:>12}{stats["conv_1"]:>12}\n')
    for si, blocks in enumerate(arch.stages):
        h //= 2
        keys = [f"stage{si + 2}_block{bi}" for bi in range(len(blocks))]
        p = sum(params[k] for k in keys)
        n = sum(stats[k] for k in keys)
        shape = (1, t, h, h, blocks[0].out_channels)
        w(f'{f"stage{si + 2} ({len(blocks)} blocks)":<28}{str(shape):<26}'
          f'{p:>12}{n:>12}\n')
    w(f'{"conv_5":<28}{str((1, t, h, h, arch.conv5_dim)):<26}'
      f'{params["conv_5"]:>12}{stats["bn_5"]:>12}\n')
    w(f'{"pool_5 + fc_1":<28}{str((1, arch.head_dim)):<26}'
      f'{params["fc_1"]:>12}{0:>12}\n')
    w(f'{"fc_2":<28}{str((1, arch.num_classes)):<26}'
      f'{params["fc_2"]:>12}{0:>12}\n')
    w("-" * 78 + "\n")
    total_p, total_s = sum(params.values()), sum(stats.values())
    w(f'Trainable params:     {total_p:,}\n')
    w(f'BN running statistics:{total_s:>12,}\n')
    w(f'Total:                {total_p + total_s:,}\n')
    return out.getvalue()


def build_parser() -> argparse.ArgumentParser:
    from x3d_tpu_torch.tools.common import add_bool_flag

    p = argparse.ArgumentParser(
        prog="x3d_tpu_torch.tools.summary",
        description="Per-module parameter and BN-statistic counts.")
    p.add_argument("--variant", default=None, choices=VARIANTS,
                   help="XS/S/M/L/XL")
    add_bool_flag(p, "all", False, "Summarise every variant.")
    p.add_argument("--output_dir", default=None,
                   help="Write golden files here.")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.all and args.variant is None:
        parser.error("give --variant or --all")
    for name in VARIANTS if args.all else [args.variant]:
        text = summarize(name)
        if args.output_dir:
            os.makedirs(args.output_dir, exist_ok=True)
            path = os.path.join(args.output_dir, f"X3D_{name}.txt")
            with open(path, "w") as f:
                f.write(text)
            print("wrote", path)
        else:
            print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
