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


CODE_BITS = 9                 # frame indices and labels below 512
CODE_BLOCK = 16               # one bit a flat 16x16 block (an MCU)


def coded_video(frames: int, height: int, width: int, label: int,
                seed: int = 0, device=None) -> torch.Tensor:
    """(frames, height, width, 3) uint8 frames for shard tests: a smooth
    texture that moves from frame to frame, and in the top-left corner each
    frame's index (first block row) and ``label`` (second) as flat 16x16
    black or white blocks, one a bit, which survive JPEG
    (:func:`read_code` reads them back).  Made from ``seed`` on ``device``
    (CUDA unless the caller asks for another)."""
    device = resolve_device(device)
    if width < CODE_BITS * CODE_BLOCK or height < 2 * CODE_BLOCK:
        raise ValueError(f"frames of {height}x{width} cannot hold the codes")
    gen = torch.Generator(device=device).manual_seed(seed)
    phase = torch.rand((3,), generator=gen, device=device) * 6.28
    y = torch.arange(height, device=device, dtype=torch.float32)[:, None]
    x = torch.arange(width, device=device, dtype=torch.float32)[None, :]
    t = torch.arange(frames, device=device, dtype=torch.float32)
    img = torch.stack([
        128 + 60 * torch.sin(x[None] / (23 + 7 * c) + y[None] / (31 - 5 * c)
                             + t[:, None, None] * 0.2 + phase[c])
        + 50 * torch.cos(y[None] / (17 + 3 * c) - t[:, None, None] * 0.1)
        for c in range(3)], dim=-1)
    out = img.clamp(0, 255).to(torch.uint8)
    bits = torch.arange(CODE_BITS, device=device)
    for row, value in ((0, t.to(torch.int64)),
                       (1, torch.full((frames,), int(label), device=device))):
        on = ((value[:, None] >> bits[None, :]) & 1).to(torch.uint8) * 255
        block = on.repeat_interleave(CODE_BLOCK, dim=1)        # (F, 9*16)
        out[:, row * CODE_BLOCK:(row + 1) * CODE_BLOCK,
            :CODE_BITS * CODE_BLOCK] = block[:, None, :, None]
    return out


def read_code(frames: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) decoded frames -> (..., 2) int64: the index and label
    that :func:`coded_video` wrote, read from the centre 8x8 of each
    block."""
    c = CODE_BLOCK
    rows = []
    for row in (0, 1):
        band = frames[..., row * c + 4:row * c + 12, :CODE_BITS * c, :]
        band = band.to(torch.float32).mean(dim=(-3, -1))       # (..., 9*16)
        cells = band.unflatten(-1, (CODE_BITS, c))[..., 4:12].mean(-1)
        bits = (cells > 127.5).to(torch.int64)
        weights = 2 ** torch.arange(CODE_BITS, device=frames.device)
        rows.append((bits * weights).sum(-1))
    return torch.stack(rows, dim=-1)
