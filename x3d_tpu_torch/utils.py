"""Width/depth expansion math, pixel normalisation and device choice."""

from __future__ import annotations

import math
from typing import Sequence

import torch


def round_width(width: int, multiplier: float, min_width: int = 8,
                divisor: int = 8) -> int:
    """Scale a channel count and round to a multiple of ``divisor``.

    The result never drops below ``min_width`` nor below 90% of the scaled
    width (in which case one extra ``divisor`` is added).  This is the rule
    that turns the base plan (24, 48, 96, 192) into the published X3D
    channel plans.
    """
    if not multiplier:
        return width
    scaled = width * multiplier
    min_width = min_width or divisor
    rounded = max(min_width, int(scaled + divisor / 2) // divisor * divisor)
    if rounded < 0.9 * scaled:
        rounded += divisor
    return int(rounded)


def round_repeats(repeats: int, multiplier: float) -> int:
    """Scale a stage depth, rounding up."""
    if not multiplier:
        return repeats
    return int(math.ceil(multiplier * repeats))


def normalize(clips: torch.Tensor, mean: Sequence[float],
              std: Sequence[float], norm_value: float = 255.0) -> torch.Tensor:
    """uint8-range pixels -> standardised float32, channelwise (last axis)."""
    mean_t = torch.tensor(mean, dtype=torch.float32, device=clips.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=clips.device)
    x = clips.to(torch.float32) / norm_value
    return (x - mean_t) / std_t


def denormalize(clips: torch.Tensor, mean: Sequence[float],
                std: Sequence[float], norm_value: float = 255.0,
                out_dtype: torch.dtype = torch.uint8) -> torch.Tensor:
    """Inverse of :func:`normalize`, for visualisation tooling: standardised
    values back to [0, norm_value] pixels in ``out_dtype`` (the fraction
    dropped, as the JAX package's ``astype`` does)."""
    mean_t = torch.tensor(mean, dtype=torch.float32, device=clips.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=clips.device)
    x = clips.to(torch.float32) * std_t + mean_t
    x = torch.clamp(x * norm_value, 0, norm_value)
    return x.to(out_dtype)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  Raises instead of quietly running on the CPU when no card is
    present."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


def use_deterministic_cudnn() -> None:
    """Ask cuDNN (the stem's full conv) for deterministic algorithms and no
    autotuning, so that a step on the card repeats bit for bit and a resumed
    run equals an uninterrupted one, as the reference's pure step does.  The
    flags are process-wide."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def use_full_float32() -> None:
    """Keep float32 convolutions (cuDNN) and products (cuBLAS) out of TF32,
    which PyTorch allows cuDNN by default: a float32 run computes in float32,
    as the reference does.  The flags are process-wide."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
