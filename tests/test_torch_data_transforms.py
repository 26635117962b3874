"""The port's clip sampling and crop geometry (``data/transforms.py``)
against the JAX package's (``x3d_tpu/data/transforms.py``, TensorFlow ops):
eval frame indices equal the JAX sampler's for every video length 1-400
and 1-10 views; training indices and crop windows keep the JAX formulas'
invariants (and JAX's own windows keep them too); the short-side sizes and
the uniform crops' offsets equal JAX's; a record's draws depend only on
(seed, epoch, index).
"""

import numpy as np
import pytest
import tensorflow as tf

from x3d_tpu.data import transforms as jax_transforms
from x3d_tpu_torch.data import transforms


@pytest.mark.parametrize("frames", [4, 13, 16])
def test_eval_indices_equal_jax(frames):
    for views in range(1, 11):
        port = transforms.TemporalSampler(False, 5, frames, views)
        jax = jax_transforms.TemporalSampler(False, 5, frames, views)
        for size in range(1, 401):
            np.testing.assert_array_equal(
                port.indices(size), jax.indices(size).numpy(),
                err_msg=f"T={frames} V={views} size={size}")


@pytest.mark.parametrize("rate,frames", [(12, 4), (6, 13), (5, 16)])
def test_train_indices_keep_the_jax_formula(rate, frames):
    port = transforms.TemporalSampler(True, rate, frames)
    jax = jax_transforms.TemporalSampler(True, rate, frames, seed=3)
    k = np.arange(frames)
    starts = set()
    for size in (1, 2, 7, 40, 300):
        for i in range(50):
            idx = port.indices(size, transforms.record_rng(0, 0, i))
            start = int(idx[0])
            assert 0 <= start < size
            np.testing.assert_array_equal(idx, (start + k * rate) % size)
            starts.add((size, start))
            ref = jax.indices(size).numpy()
            np.testing.assert_array_equal(ref, (ref[0] + k * rate) % size)
    assert len({s for n, s in starts if n == 300}) > 25   # spread out


def _box_ok(y, x, side, h, w, crop, lo, hi):
    short = min(h, w)
    assert 1 <= side <= short
    assert side >= min(short, np.floor(np.float32(crop) * short
                                       / np.float32(hi))) - 1
    assert side <= max(1, np.floor(np.float32(crop) * short
                                   / np.float32(lo)))
    assert 0 <= y <= h - side and 0 <= x <= w - side


@pytest.mark.parametrize("h,w,crop,lo,hi", [
    (256, 340, 224, 256, 320), (340, 256, 160, 182, 228),
    (240, 320, 312, 356, 446), (36, 48, 32, 36, 44), (20, 30, 32, 36, 44)])
def test_train_box_invariants(h, w, crop, lo, hi):
    planner = jax_transforms.CropBoxPlanner(lo, hi, crop, True, seed=1)
    sides = set()
    for i in range(100):
        y, x, side = transforms.train_box(h, w, crop, lo, hi,
                                          transforms.record_rng(5, 1, i))
        _box_ok(y, x, side, h, w, crop, lo, hi)
        sides.add(side)
        jy, jx, jh, jw = planner.train_box(h, w).numpy()
        assert jh == jw
        _box_ok(jy, jx, jh, h, w, crop, lo, hi)
    assert len(sides) > 1 or min(h, w) < crop


@pytest.mark.parametrize("flip_mode,want", [(0, 0.0), (2, 1.0), (1, 0.5)])
def test_train_map_flips(flip_mode, want):
    flips = [int(transforms.train_map(256, 340, 224, 256, 320,
                                      transforms.record_rng(0, 0, i),
                                      flip_mode)["flip"][0])
             for i in range(400)]
    assert abs(np.mean(flips) - want) < 0.08


def test_train_map_geometry():
    m = transforms.train_map(256, 340, 224, 256, 320,
                             transforms.record_rng(2, 0, 9))[0]
    side = int(m["win_h"])
    assert m["win_w"] == side and m["off_y"] == m["off_x"] == 0
    assert m["scale_y"] == m["scale_x"] == np.float32(side) / np.float32(224)


def test_record_draws_depend_on_seed_epoch_index():
    a = transforms.record_rng(1, 2, 3).random(4)
    np.testing.assert_array_equal(a, transforms.record_rng(1, 2, 3).random(4))
    for other in [(2, 2, 3), (1, 3, 3), (1, 2, 4)]:
        assert not np.array_equal(a, transforms.record_rng(*other).random(4))


_SIZES = [(256, 340), (340, 256), (240, 320), (320, 240), (36, 48),
          (48, 36), (32, 48), (48, 32), (33, 33), (101, 47), (160, 160)]


@pytest.mark.parametrize("h,w", _SIZES)
@pytest.mark.parametrize("crop", [32, 160, 224])
def test_short_side_sizes_equal_jax(h, w, crop):
    st = jax_transforms.SpatialTransforms(0, 0, crop, False)
    clip = tf.zeros((1, h, w, 1), tf.uint8)
    out = st._short_side_resize(clip, float(crop))
    new_h, new_w, same = transforms.short_side_size(h, w, crop)
    assert (new_h, new_w) == tuple(out.shape[1:3])
    assert same == (min(h, w) == crop)


@pytest.mark.parametrize("h,w", [(256, 298), (298, 256), (224, 224),
                                 (32, 43), (43, 32), (33, 32)])
@pytest.mark.parametrize("num_crops", [1, 3])
def test_uniform_crop_offsets_equal_jax(h, w, num_crops):
    crop = min(h, w) if min(h, w) < 224 else 224
    st = jax_transforms.SpatialTransforms(0, 0, crop, False,
                                          num_crops=num_crops)
    pos = np.arange(h * w, dtype=np.int32).reshape(1, h, w, 1)
    offsets = transforms.uniform_crop_offsets(h, w, crop, num_crops)
    for i, (y, x) in enumerate(offsets):
        idx = i % 3 if num_crops > 1 else 1
        ref = st._uniform_crop(tf.constant(pos), idx).numpy()
        np.testing.assert_array_equal(ref, pos[:, y:y + crop, x:x + crop])


def test_two_crops_are_refused():
    with pytest.raises(ValueError, match="1 or 3"):
        transforms.uniform_crop_offsets(256, 340, 224, 2)


def test_eval_maps_read_the_whole_frame():
    maps = transforms.eval_maps(256, 340, 224, 3)
    assert list(maps["win_h"]) == [256] * 3
    assert list(maps["win_w"]) == [340] * 3
    assert list(maps["off_x"]) == [0, 37, 73]       # 297 wide, 224 crop
    assert maps["scale_y"][0] == np.float32(256) / np.float32(224)
    same = transforms.eval_maps(224, 300, 224, 1)
    assert same["scale_x"][0] == same["scale_y"][0] == 1.0
