"""Synthetic data: device-resident batches for smoke training and timing.

The counterpart of the JAX package's ``x3d_tpu/data/synthetic.py``: one
batch with the config's real shapes, drawn once from an explicit
``torch.Generator`` on the chosen device and yielded again and again.
"""

from __future__ import annotations

from typing import Iterator, Optional

import torch

from x3d_tpu_torch.utils import resolve_device


def synthetic_batches(cfg, batch_size: int, is_training: bool = True,
                      dtype: torch.dtype = torch.bfloat16,
                      steps: Optional[int] = None, seed: int = 0,
                      device=None) -> Iterator[dict]:
    """Yield {'video', 'label'} batches: ``video`` (batch × views, T, S, S,
    C) standard normal in ``dtype``, ``label`` (batch,) int64.  Eval batches
    carry the config's views per video.  CUDA unless the caller asks for
    another device."""
    device = resolve_device(device)
    T = cfg.DATA.TEMP_DURATION
    S = cfg.DATA.TRAIN_CROP_SIZE if is_training else cfg.DATA.TEST_CROP_SIZE
    C = cfg.DATA.NUM_INPUT_CHANNELS
    views = 1 if is_training else (
        cfg.TEST.NUM_TEMPORAL_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS)
    gen = torch.Generator(device=device).manual_seed(seed)
    video = torch.randn((batch_size * views, T, S, S, C), generator=gen,
                        device=device).to(dtype)
    label = torch.randint(0, cfg.NETWORK.NUM_CLASSES, (batch_size,),
                          generator=gen, device=device)
    i = 0
    while steps is None or i < steps:
        yield {"video": video, "label": label}
        i += 1
