"""Clip sampling and spatial geometry for the input pipeline, in numpy.

The counterpart of the JAX package's ``x3d_tpu/data/transforms.py`` (tf.data
graph ops there): the same frame indices and the same crop geometry,
computed on the host before anything is decoded, each clip frame's spatial
transform ending up as one bilinear map for the clip kernel
(``ops/clip_prep.MAP_DTYPE``).

Randomness is explicit: every record gets its own ``np.random.Generator``
from (seed, epoch, record index) (:func:`record_rng`), as the JAX package's
C++ loader derives one from (seed, record index) (``clip_loader.cc``), so a
batch does not depend on how many threads prepared it.  The draws are the
JAX formulas' (random start; jitter scale, window and flip of the fast
crop), not TensorFlow's random streams.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from x3d_tpu_torch.ops.clip_prep import MAP_DTYPE


def record_rng(seed: int, epoch: int, index: int) -> np.random.Generator:
    """The generator of one record's random draws."""
    return np.random.default_rng([int(seed), int(epoch), int(index)])


class TemporalSampler:
    """Which frame indices form the clip(s) of a video (JAX
    ``transforms.py:39-77``).

    Train: one clip, a random start in [0, size), stride ``sample_rate``,
    looping past the end.  Eval: ``num_views`` back-to-back clips from
    frame 0 at the adaptive stride ``max(1, size // num_frames)`` over the
    looped video.
    """

    def __init__(self, is_training: bool, sample_rate: int, num_frames: int,
                 num_views: int = 1):
        self.is_training = is_training
        self.rate = sample_rate
        self.frames = num_frames
        self.views = 1 if is_training else num_views

    def indices(self, size: int,
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """(T,) indices for train, (V*T,) for eval, in [0, size)."""
        if size <= 0:
            raise ValueError(f"a video of {size} frames")
        if self.is_training:
            start = int(rng.integers(0, size))
            k = np.arange(self.frames, dtype=np.int64)
            return (start + k * self.rate) % size
        rate = max(1, size // self.frames)
        k = np.arange(self.frames * self.views, dtype=np.int64)
        return (k * rate) % size


def _f32(v) -> np.float32:
    return np.float32(v)


def short_side_size(height: int, width: int, size
                    ) -> Tuple[int, int, bool]:
    """(new height, new width, unchanged) of the short-side resize to
    ``size`` (an int, or training's float32 jitter size): the long side
    floored in float32 and both sides truncated to int, as JAX
    ``transforms.py:108-129``; unchanged where the short side already is
    ``size`` (no resize at all there)."""
    h, w, s = _f32(height), _f32(width), _f32(size)
    if (w <= h and w == s) or (h <= w and h == s):
        return height, width, True
    if w < h:
        return int(np.floor(h / w * s)), int(s), False
    return int(s), int(np.floor(w / h * s)), False


def _resize_scales(height: int, width: int, new_h: int, new_w: int,
                   same: bool):
    """tf.image.resize's scale in each axis, in_size / float(out_size)
    (1 where the frame is not resized)."""
    if same:
        return _f32(1), _f32(1)
    return _f32(height) / _f32(new_h), _f32(width) / _f32(new_w)


def uniform_crop_offsets(height: int, width: int, crop: int,
                         num_crops: int) -> List[Tuple[int, int]]:
    """(y, x) of each eval crop in a (height, width) frame: centre, or
    left/centre/right (top/centre/bottom for a tall frame) in that order,
    the centre at ceil((dim - crop) / 2) (JAX ``transforms.py:131-147``)."""
    if num_crops not in (1, 3):
        raise ValueError(
            f"TEST.NUM_SPATIAL_CROPS must be 1 or 3, got {num_crops}")
    yc = int(np.ceil(_f32(height - crop) / _f32(2)))
    xc = int(np.ceil(_f32(width - crop) / _f32(2)))
    tall = height > width
    out = []
    for i in range(num_crops):
        idx = i % 3 if num_crops > 1 else 1
        y, x = yc, xc
        if idx == 0:
            y, x = (0, xc) if tall else (yc, 0)
        elif idx == 2:
            y, x = (height - crop, xc) if tall else (yc, width - crop)
        out.append((y, x))
    return out


def _map(win_y, win_x, win_h, win_w, off_y, off_x, scale_y, scale_x, flip):
    m = np.zeros((), MAP_DTYPE)
    m["win_y"], m["win_x"], m["win_h"], m["win_w"] = win_y, win_x, win_h, win_w
    m["off_y"], m["off_x"], m["flip"] = off_y, off_x, int(flip)
    m["scale_y"], m["scale_x"] = scale_y, scale_x
    return m


def eval_maps(height: int, width: int, crop: int,
              num_crops: int) -> np.ndarray:
    """One map a crop (crop-major order) for eval: the short-side resize
    to ``crop`` and the uniform crops of JAX ``SpatialTransforms
    .eval_views``, as windows of the whole decoded frame."""
    new_h, new_w, same = short_side_size(height, width, crop)
    sy, sx = _resize_scales(height, width, new_h, new_w, same)
    maps = [_map(0, 0, height, width, y, x, sy, sx, False)
            for y, x in uniform_crop_offsets(new_h, new_w, crop, num_crops)]
    if new_h < crop or new_w < crop:
        raise ValueError(f"crop {crop} larger than the resized frame "
                         f"{(new_h, new_w)}")
    return np.stack(maps)


def train_box(height: int, width: int, crop: int, jitter_min: float,
              jitter_max: float, rng: np.random.Generator
              ) -> Tuple[int, int, int]:
    """(y, x, side) of the training crop window in the frame (JAX
    ``CropBoxPlanner.train_box``, ``transforms.py:223-240``): the window
    that a short-side resize to a jitter scale in [min, max) followed by a
    ``crop`` square would cover, never larger than the frame."""
    h, w = _f32(height), _f32(width)
    scale = _f32(rng.uniform(jitter_min, jitter_max))
    short = min(h, w)
    side = np.floor(_f32(crop) * short / scale)
    side = max(min(side, short), _f32(1))
    side = int(side)
    y = int(rng.integers(0, height - side + 1))
    x = int(rng.integers(0, width - side + 1))
    return y, x, side


def train_map(height: int, width: int, crop: int, jitter_min: float,
              jitter_max: float, rng: np.random.Generator,
              flip_mode: int = 1) -> np.ndarray:
    """The fast crop's map for training (JAX ``pipeline.py:142-201``): the
    window of :func:`train_box` resized to (crop, crop), mirrored with
    probability one half (``flip_mode`` 1), always (2, the reference's
    flip bug) or never (0)."""
    y, x, side = train_box(height, width, crop, jitter_min, jitter_max, rng)
    flip = flip_mode == 2 or (flip_mode == 1 and rng.random() < 0.5)
    scale = _f32(side) / _f32(crop)
    return _map(y, x, side, side, 0, 0, scale, scale, flip)[None]


def exact_map(height: int, width: int, crop: int, size, y: int, x: int,
              flip: bool) -> np.ndarray:
    """The map of JAX ``SpatialTransforms.train_clip``'s geometry for given
    draws (``transforms.py:149-168``): the whole frame resized so its short
    side is ``size`` (:func:`short_side_size`), the ``crop`` square at
    (y, x) of the resized frame, mirrored where ``flip``."""
    new_h, new_w, same = short_side_size(height, width, size)
    if not (0 <= y <= new_h - crop and 0 <= x <= new_w - crop):
        raise ValueError(f"crop {crop} at {(y, x)} outside the resized "
                         f"frame {(new_h, new_w)}")
    sy, sx = _resize_scales(height, width, new_h, new_w, same)
    return _map(0, 0, height, width, y, x, sy, sx, flip)[None]


def train_exact_map(height: int, width: int, crop: int, jitter_min: float,
                    jitter_max: float, rng: np.random.Generator,
                    flip_mode: int = 1) -> np.ndarray:
    """Training's exact geometry, which the raw-video path takes (JAX's
    fast crop needs TFRecords, ``pipeline.py:85-86``): a float32 jitter
    size in [min, max), a uniform crop of the frame resized to it, and the
    flip of :func:`train_map`'s ``flip_mode``; the draws from ``rng``, in
    that order."""
    size = _f32(rng.uniform(jitter_min, jitter_max))
    new_h, new_w, _ = short_side_size(height, width, size)
    if new_h < crop or new_w < crop:
        raise ValueError(f"crop {crop} larger than the resized frame "
                         f"{(new_h, new_w)}")
    y = int(rng.integers(0, new_h - crop + 1))
    x = int(rng.integers(0, new_w - crop + 1))
    flip = flip_mode == 2 or (flip_mode == 1 and rng.random() < 0.5)
    return exact_map(height, width, crop, size, y, x, flip)
