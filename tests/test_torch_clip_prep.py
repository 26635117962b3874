"""The clip kernel's plain version against the JAX package's geometry, and
the kernel against its plain version on the card.

CPU: on frames that TensorFlow decodes with ``INTEGER_ACCURATE`` (what
Pillow and nvJPEG's plain version give), the plain clip prep equals JAX's
``SpatialTransforms.eval_views`` followed by ``device_prep`` bit for bit,
at the uint8 stage and after normalisation in bfloat16: 1 and 3 crops,
both orientations, and a short side that already equals the crop.  In
float32 it equals the port's ``utils.normalize`` of JAX's uint8 clips bit
for bit, and JAX's ``device_prep`` within 1e-6: XLA multiplies by the
reciprocals of 255 and of std where PyTorch divides (measured at most
4.8e-7 over these cases, a few float32 ulps of u / 255; no bfloat16 value
moved).  It also equals the fast crop's path (``tf.image.resize`` of a
window to the crop, flipped, cast to uint8) on the same frames, bit for
bit.  TensorFlow's resize arithmetic is matched exactly, so no level of
tolerance is allowed anywhere.

Card (marker ``cuda``; ``python -m pytest --noconftest -m cuda
tests/test_torch_clip_prep.py``): the kernel against its plain version bit
for bit in every output dtype, at edge maps (1x1 frames, scale 1, taps
clamped at every border, odd widths, up- and down-scaling, flips) and at
random maps.
"""

import numpy as np
import pytest
import torch

from x3d_tpu_torch.data import transforms
from x3d_tpu_torch.ops import clip_prep, jpeg
from x3d_tpu_torch.utils import normalize

MEAN = (0.45, 0.45, 0.45)
STD = (0.225, 0.225, 0.225)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _frames(n, h, w, seed=0):
    """JPEG frames with texture, decoded by TensorFlow's accurate IDCT."""
    import tensorflow as tf

    rng = np.random.default_rng(seed)
    y = np.arange(h)[:, None, None]
    x = np.arange(w)[None, :, None]
    out = []
    for i in range(n):
        img = (y * 3 + x * 2 + i * 11 + 40 * np.sin(x / 3.0 + y / 5.0 + i)
               + rng.integers(0, 30, (h, w, 3))) % 256
        blob = jpeg.encode(img.astype(np.uint8)[None], device="cpu")[0]
        out.append(tf.io.decode_jpeg(blob, channels=3,
                                     dct_method="INTEGER_ACCURATE").numpy())
    return np.stack(out)


def _arena(frames):
    n, h, w, _ = frames.shape
    offsets, total = jpeg.arena_layout([(h, w)] * n)
    arena = torch.zeros(total, dtype=torch.uint8)
    for f, off in zip(frames, offsets):
        arena[off:off + f.size] = torch.from_numpy(f.reshape(-1))
    return arena, offsets


def _eval_table(frames, crop, num_crops):
    n, h, w, _ = frames.shape
    _, offsets = _arena(frames)
    maps = transforms.eval_maps(h, w, crop, num_crops)
    rows = np.repeat(maps, n)
    rows["src"] = np.tile(offsets, num_crops)
    rows["pitch"] = w * 3
    return rows


@pytest.mark.parametrize("h,w,crop", [(36, 48, 32), (48, 36, 32),
                                      (32, 45, 32), (45, 32, 32),
                                      (37, 53, 24)])
@pytest.mark.parametrize("num_crops", [1, 3])
def test_eval_geometry_equals_jax(h, w, crop, num_crops):
    import jax.numpy as jnp
    import tensorflow as tf

    from x3d_tpu.data import transforms as jax_transforms
    from x3d_tpu.data.device import device_prep

    frames = _frames(6, h, w)
    views = frames.reshape(2, 3, h, w, 3)
    st = jax_transforms.SpatialTransforms(0, 0, crop, False,
                                          num_crops=num_crops)
    ref = tf.cast(st.eval_views(tf.constant(views)), tf.uint8).numpy()
    arena, _ = _arena(frames)
    table = _eval_table(frames, crop, num_crops)
    shape = (2 * num_crops, 3, crop, crop, 3)
    got = clip_prep.clip_prep(arena, table, shape, torch.uint8)
    np.testing.assert_array_equal(got.numpy(), ref)

    class Cfg:
        class DATA:
            pass
    Cfg.DATA.MEAN, Cfg.DATA.STD = MEAN, STD
    out = clip_prep.clip_prep(arena, table, shape, torch.bfloat16, MEAN, STD)
    want = np.asarray(device_prep(Cfg, jnp.bfloat16)(ref).astype(jnp.float32))
    np.testing.assert_array_equal(out.to(torch.float32).numpy(), want)
    out = clip_prep.clip_prep(arena, table, shape, torch.float32, MEAN, STD)
    assert torch.equal(out, normalize(torch.from_numpy(ref), MEAN, STD))
    want = np.asarray(device_prep(Cfg, jnp.float32)(ref))
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("h,w", [(36, 48), (48, 36)])
@pytest.mark.parametrize("box,flip", [((2, 5, 30), False),
                                      ((0, 0, 36), True),
                                      ((5, 1, 17), True)])
def test_fast_crop_equals_the_tf_resize_path(h, w, box, flip):
    import tensorflow as tf

    frames = _frames(3, h, w, seed=1)
    y, x, side = box
    crop = 32
    win = frames[:, y:y + side, x:x + side]
    ref = tf.image.resize(tf.constant(win), [crop, crop])
    if flip:
        ref = tf.image.flip_left_right(ref)
    ref = tf.cast(ref, tf.uint8).numpy()
    arena, offsets = _arena(frames)
    scale = np.float32(side) / np.float32(crop)
    table = np.zeros(3, clip_prep.MAP_DTYPE)
    for k in range(3):
        table[k] = (offsets[k], w * 3, y, x, side, side, 0, 0, int(flip),
                    scale, scale)
    got = clip_prep.clip_prep(arena, table, (1, 3, crop, crop, 3),
                              torch.uint8)
    np.testing.assert_array_equal(got[0].numpy(), ref)


def test_bad_arguments_raise():
    arena = torch.zeros(100, dtype=torch.uint8)
    table = np.zeros(2, clip_prep.MAP_DTYPE)
    with pytest.raises(ValueError, match="N \\* T map rows"):
        clip_prep.clip_prep(arena, table, (1, 3, 4, 4, 3))
    with pytest.raises(TypeError, match="output dtype"):
        clip_prep.clip_prep(arena, table, (1, 2, 4, 4, 3), torch.float16)
    with pytest.raises(ValueError, match="flat uint8"):
        clip_prep.clip_prep(arena.float(), table, (1, 2, 4, 4, 3))


def test_bound_counts_the_window_once():
    table = np.zeros(4, clip_prep.MAP_DTYPE)
    table["pitch"] = 30
    table["win_h"] = table["win_w"] = 10
    table["scale_y"] = table["scale_x"] = 1.0
    table["src"] = [0, 0, 300, 300]
    # two frames, each 10x10 read once; 4 x 10x10x3 bytes written
    assert clip_prep.bound_bytes(table, (1, 4, 10, 10, 3), torch.uint8) \
        == 2 * 300 + 4 * 300


def _edge_table(rng, sizes, S):
    """Maps over frames of ``sizes``: whole frames at scale 1, clamped
    windows, up- and down-scaling, odd widths, flips."""
    offsets, total = jpeg.arena_layout(sizes)
    rows = []
    for k, (h, w) in enumerate(sizes):
        for case in range(4):
            wh = h if case != 3 else max(1, h // 2)
            ww = w if case != 3 else max(1, w - 1)
            wy = 0 if case != 3 else int(rng.integers(0, h - wh + 1))
            wx = 0 if case != 3 else int(rng.integers(0, w - ww + 1))
            if case == 0:
                sy = sx = np.float32(1)
                oy, ox = int(rng.integers(0, 3)), int(rng.integers(0, 3))
            else:
                sy = np.float32(wh) / np.float32(S + case)
                sx = np.float32(ww) / np.float32(S + 2 * case)
                oy = ox = case - 1
            rows.append((offsets[k], w * 3, wy, wx, wh, ww, oy, ox,
                         case % 2, sy, sx))
    table = np.array(rows, clip_prep.MAP_DTYPE)
    return table, total


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32,
                                   torch.bfloat16])
def test_kernel_equals_plain_version_at_edges(cuda, dtype):
    rng = np.random.default_rng(0)
    sizes = [(1, 1), (1, 7), (5, 1), (9, 13), (31, 17), (64, 101)]
    for S in (1, 3, 16, 33):
        table, total = _edge_table(rng, sizes, S)
        arena = torch.from_numpy(
            rng.integers(0, 256, total, dtype=np.uint8)).to(cuda)
        shape = (len(table), 1, S, S, 3)
        got = clip_prep.clip_prep(arena, table, shape, dtype, MEAN, STD)
        want = clip_prep.clip_prep_reference(arena, table, shape, dtype,
                                             MEAN, STD)
        assert torch.equal(got.cpu(), want.cpu()), (S, dtype)


@pytest.mark.cuda
def test_kernel_equals_plain_version_on_random_maps(cuda):
    rng = np.random.default_rng(1)
    sizes = [(256, 340), (340, 256), (240, 320)]
    offsets, total = jpeg.arena_layout(sizes)
    arena = torch.from_numpy(
        rng.integers(0, 256, total, dtype=np.uint8)).to(cuda)
    T, S = 4, 160
    rows = []
    for n in range(12):
        k = n % 3
        h, w = sizes[k]
        if n % 2:
            m = transforms.train_map(h, w, S, 182, 228,
                                     transforms.record_rng(0, 0, n))[0]
            rows += [m] * T
        else:
            m = transforms.eval_maps(h, w, S, 3)[n % 3]
            rows += [m] * T
    table = np.array(rows, clip_prep.MAP_DTYPE)
    table["src"] = [offsets[(i // T) % 3] for i in range(len(table))]
    table["pitch"] = [sizes[(i // T) % 3][1] * 3 for i in range(len(table))]
    for dtype in (torch.uint8, torch.bfloat16):
        shape = (12, T, S, S, 3)
        got = clip_prep.clip_prep(arena, table, shape, dtype, MEAN, STD)
        want = clip_prep.clip_prep_reference(arena, table, shape, dtype,
                                             MEAN, STD)
        assert torch.equal(got.cpu(), want.cpu())
