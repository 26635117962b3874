"""The port's InputReader on the CPU against the JAX package's two loaders,
and on the card against itself on the CPU.

CPU (Pillow decode, the clip kernel's plain version, tiny 36x48 frames,
XS geometry with 32² crops, one torch thread):

* Eval against JAX's ``NativeClipLoader`` with one thread, 1 and 3 crops,
  over three shards: labels, order and batch count equal; uint8 clips
  within one level on at most 0.1% of the values.  Not bit for bit: the
  decoded frames are equal (libjpeg's accurate IDCT in both), but the C++
  loader's library is built with ``-O3 -march=native`` and g++ contracts
  its resize's multiply-adds, which rounds once where TensorFlow and the
  port round twice (emulating fused multiply-adds reproduces it exactly).
  Measured: 5-20 values of 221184 a batch, 0.009%, each by one level.
  The port's own maps run with fused multiply-adds on the port's decoded
  frames give the C++ loader's clips bit for bit.
* Eval against JAX's tf.data ``InputReader`` (one shard): labels and order
  equal, clips within the gap between TensorFlow's default INTEGER_FAST
  decode and the accurate one, measured in the test on the same frames.
* Training: batches identical with 1 and 4 threads for one seed, another
  seed gives other batches, the loader loops past an epoch, labels are the
  records'.  A bad JPEG raises and names the shard and the record.

Card (marker ``cuda``; ``python -m pytest --noconftest -m cuda
tests/test_torch_pipeline.py``): eval batches on the card, with Pillow
blocked, have the CPU loader's labels and maps and equal the plain clip
prep on nvJPEG's own decoded frames bit for bit (nvJPEG's IDCT and chroma
upsampling are not libjpeg's, so its frames differ from Pillow's);
training batches repeat for a seed and thread count; a training reader and
an eval reader interleaved on one card give what each gives alone.
"""

import glob
import os
import sys

import numpy as np
import pytest
import torch

from x3d_tpu_torch import variant_config
from x3d_tpu_torch.data import InputReader, tfrecords
from x3d_tpu_torch.ops import jpeg

T = 4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _video(n, h=36, w=48, base=0):
    rng = np.random.default_rng(base)
    y = np.arange(h)[:, None, None]
    x = np.arange(w)[None, :, None]
    return np.stack([
        ((y * 3 + x * 2 + i * 11 + 40 * np.sin(x / 3 + y / 5 + i)
          + rng.integers(0, 30, (h, w, 3))) % 256).astype(np.uint8)
        for i in range(n)])


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Three shards of 2 + 2 + 1 videos (one of them tall), written by the
    port's writer on the CPU, and one shard of 4 videos."""
    d = tmp_path_factory.mktemp("pipeline")
    videos = [(_video(20 + 3 * i, base=i), i) for i in range(4)]
    videos.append((_video(17, h=48, w=36, base=9), 4))
    tfrecords.write_video_array_shards(videos, str(d), prefix="v",
                                       videos_per_record=2, device="cpu")
    tfrecords.write_video_array_shards(videos[:4], str(d), prefix="one",
                                       videos_per_record=4, device="cpu")
    return d


def _cfg(make, crops=1, views=3):
    cfg = make("XS")
    cfg.DATA.TRAIN_JITTER_SCALES = [36, 44]
    cfg.DATA.TRAIN_CROP_SIZE = 32
    cfg.DATA.TEST_CROP_SIZE = 32
    cfg.DATA.TEMP_DURATION = T
    cfg.TEST.NUM_TEMPORAL_VIEWS = views
    cfg.TEST.NUM_SPATIAL_CROPS = crops
    return cfg


def _port_eval(pattern, crops, device="cpu", batch=2, **kw):
    reader = InputReader(_cfg(variant_config, crops), False, device=device,
                         dtype=torch.uint8, **kw)
    return [{"video": b["video"].cpu().numpy(),
             "label": b["label"].cpu().numpy()}
            for b in reader(pattern, batch)]


@pytest.mark.parametrize("crops", [1, 3])
def test_eval_against_the_native_loader(shards, crops):
    from x3d_tpu import variant_config as jax_config
    from x3d_tpu.data import native_loader

    if not native_loader.available():
        pytest.skip(f"native loader: {native_loader.build_error()}")
    pattern = str(shards / "v-*")
    ref = list(native_loader.NativeClipLoader(
        _cfg(jax_config, crops), False, num_threads=1)(pattern, 2))
    got = _port_eval(pattern, crops, num_threads=1)
    assert len(got) == len(ref) == 2             # 5 videos, batch 2
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["label"], r["label"])
        assert g["video"].shape == r["video"].shape == (2 * 3 * crops, T,
                                                        32, 32, 3)
        diff = np.abs(g["video"].astype(int) - r["video"].astype(int))
        assert diff.max() <= 1
        assert (diff > 0).mean() <= 1e-3


def _fused_bilinear(arena, table, S):
    """The C++ loader's resize arithmetic on the port's maps: every
    multiply-add fused (rounded once), as its g++ build contracts them;
    float64 holds each product exactly before the one rounding."""
    def fma(a, b, c):
        return (np.float64(a) * np.float64(b) + np.float64(c)).astype(
            np.float32)

    out = []
    i = np.arange(S, dtype=np.float32)
    for r in table:
        frame = arena[r["src"]:r["src"] + r["win_h"] * r["pitch"]]
        frame = frame.reshape(r["win_h"], -1, 3).astype(np.float32)

        def taps(off, scale, n):
            pos = fma(i + np.float32(off) + np.float32(0.5), scale,
                      np.float32(-0.5))
            lo = np.floor(pos)
            i0 = np.maximum(lo, 0).astype(int)
            return i0, np.minimum(i0 + 1, n - 1), \
                np.clip(pos - lo, 0, 1).astype(np.float32)

        y0, y1, fy = taps(r["off_y"], r["scale_y"], r["win_h"])
        x0, x1, fx = taps(r["off_x"], r["scale_x"], r["win_w"])
        fx, fy = fx[None, :, None], fy[:, None, None]
        a, b = frame[y0][:, x0], frame[y0][:, x1]
        c, d = frame[y1][:, x0], frame[y1][:, x1]
        top, bot = fma(b - a, fx, a), fma(d - c, fx, c)
        out.append(fma(bot - top, fy, top).astype(np.uint8))
    return np.stack(out)


def test_native_loader_differs_only_by_contraction(shards):
    """The port's maps, run with the C++ loader's fused multiply-adds on
    the port's decoded frames, give the C++ loader's clips bit for bit."""
    from x3d_tpu import variant_config as jax_config
    from x3d_tpu.data import native_loader

    if not native_loader.available():
        pytest.skip(f"native loader: {native_loader.build_error()}")
    pattern = str(shards / "v-*")
    ref = next(iter(native_loader.NativeClipLoader(
        _cfg(jax_config, 3), False, num_threads=1)(pattern, 2)))
    reader = InputReader(_cfg(variant_config, 3), False, device="cpu",
                         dtype=torch.uint8)
    reader.keep_last = True
    next(reader(pattern, 2))
    plan = reader.last
    got = _fused_bilinear(plan.arena.numpy(), plan.table, 32)
    np.testing.assert_array_equal(got.reshape(ref["video"].shape),
                                  ref["video"])


def test_eval_against_the_tf_data_reader(shards):
    import tensorflow as tf

    from x3d_tpu import variant_config as jax_config
    from x3d_tpu.data.pipeline import InputReader as JaxReader

    pattern = str(shards / "one-*")
    ref = list(JaxReader(_cfg(jax_config), False).as_numpy(pattern, 2))
    got = _port_eval(pattern, 1)
    assert len(got) == len(ref) == 2
    # the decode gap on the same frames: INTEGER_FAST against accurate
    gap = 0
    for rec in tfrecords.read_shard(glob.glob(pattern)[0]):
        v = tfrecords.SequenceExampleView(rec)
        for i in range(v.size()):
            b = bytes(v.frame(i))
            fast = tf.io.decode_jpeg(b, channels=3).numpy().astype(int)
            exact = tf.io.decode_jpeg(
                b, channels=3, dct_method="INTEGER_ACCURATE").numpy()
            gap = max(gap, int(np.abs(fast - exact).max()))
    assert gap > 0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["label"], r["label"])
        diff = np.abs(g["video"].astype(int) - r["video"].astype(int))
        assert diff.max() <= gap + 1            # + the truncation's level


def _train(pattern, seed, threads, steps=4, batch=3):
    reader = InputReader(_cfg(variant_config), True, seed=seed,
                         num_threads=threads, device="cpu")
    it = reader(pattern, batch)
    return [next(it) for _ in range(steps)]


def test_training_batches_do_not_depend_on_threads(shards):
    pattern = str(shards / "v-*")
    one = _train(pattern, 7, 1)
    four = _train(pattern, 7, 4)
    for a, b in zip(one, four):
        assert torch.equal(a["video"], b["video"])
        assert torch.equal(a["label"], b["label"])
    other = _train(pattern, 8, 1)
    assert not all(torch.equal(a["video"], b["video"])
                   for a, b in zip(one, other))


def test_training_loops_past_an_epoch(shards):
    batches = _train(str(shards / "v-*"), 0, 2, steps=5)   # 15 of 5 videos
    labels = np.concatenate([b["label"].numpy() for b in batches])
    assert set(labels) == set(range(5))
    for b in batches:
        assert b["video"].shape == (3, T, 32, 32, 3)
        assert b["video"].dtype == torch.bfloat16
        assert torch.isfinite(b["video"].float()).all()
        assert b["video"].float().std() > 0.1


def test_eval_drops_the_remainder_and_keeps_order(shards):
    got = _port_eval(str(shards / "v-*"), 1, batch=3)
    assert [list(b["label"]) for b in got] == [[0, 1, 2]]


def test_no_files_raise(tmp_path):
    reader = InputReader(_cfg(variant_config), False, device="cpu")
    with pytest.raises(FileNotFoundError):
        next(reader(str(tmp_path / "none-*"), 1))


def test_a_bad_jpeg_raises_naming_shard_and_record(tmp_path):
    good = tfrecords.frames_to_sequence_example(_video(6), 0, device="cpu")
    frames = [b"not a jpeg"] * 6
    bad = tfrecords.sequence_example(frames, 1)
    path = str(tmp_path / "bad-00000.tfrecord")
    tfrecords.write_shard(path, [good, bad], device="cpu")
    reader = InputReader(_cfg(variant_config, views=1), False,
                         device="cpu")
    with pytest.raises(ValueError,
                       match=r"bad-00000\.tfrecord: record 1: not a JPEG"):
        list(reader(path, 1))


def test_keep_last_exposes_the_plan(shards):
    reader = InputReader(_cfg(variant_config), False, device="cpu",
                         dtype=torch.uint8)
    reader.keep_last = True
    batch = next(reader(str(shards / "v-*"), 2))
    plan = reader.last
    assert [r.label for r in plan.records] == list(batch["label"])
    assert len(plan.table) == 2 * 3 * T
    rate = max(1, 20 // T)
    np.testing.assert_array_equal(plan.records[0].indices,
                                  (np.arange(3 * T) * rate) % 20)


def _eval_with_plans(pattern, device, crops=3, batch=2):
    """Eval batches (uint8, on the host) and the plan of each."""
    reader = InputReader(_cfg(variant_config, crops), False, device=device,
                         dtype=torch.uint8)
    reader.keep_last = True
    out = []
    for b in reader(pattern, batch):
        out.append(({"video": b["video"].cpu(), "label": b["label"].cpu()},
                    reader.last))
    return out


@pytest.mark.cuda
def test_card_eval_matches_the_cpu_without_pillow(cuda, tmp_path,
                                                  monkeypatch):
    from x3d_tpu_torch.ops import clip_prep

    videos = [(_video(20 + i, h=64, w=80, base=i), i) for i in range(4)]
    tfrecords.write_video_array_shards(videos, str(tmp_path), prefix="c",
                                       videos_per_record=2, device="cpu")
    pattern = str(tmp_path / "c-*")
    cpu = _eval_with_plans(pattern, "cpu")
    monkeypatch.setitem(sys.modules, "PIL", None)       # blocks Pillow
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    card = _eval_with_plans(pattern, cuda)
    assert len(card) == len(cpu) == 2
    for (g, gp), (r, rp) in zip(card, cpu):
        assert gp.arena.device.type == "cuda"
        np.testing.assert_array_equal(g["label"], r["label"])
        # the same records, frames, crops and order as on the CPU ...
        np.testing.assert_array_equal(gp.table, rp.table)
        assert [p.where for p in gp.records] == [p.where for p in rp.records]
        # ... and the clips are the plain clip prep's on nvJPEG's frames
        want = clip_prep.clip_prep_reference(
            gp.arena.cpu(), gp.table, tuple(g["video"].shape), torch.uint8)
        assert torch.equal(g["video"], want)


@pytest.mark.cuda
def test_card_corrupt_bitstreams_raise(cuda, tmp_path):
    good = jpeg.encode(_video(2, h=64, w=80), device=cuda)
    with pytest.raises(jpeg.DecodeError, match="nvJPEG") as e:
        jpeg.decode_batch([good[0], b"\xff\xd8\xff" + bytes(200)],
                          [(64, 80)] * 2, cuda)
    assert e.value.index == 1
    with pytest.raises(jpeg.DecodeError, match="size differs") as e:
        jpeg.decode_batch(good, [(64, 80), (64, 81)], cuda)
    assert e.value.index == 1
    # in a shard: the record is named
    bad = tfrecords.sequence_example([good[0], good[1][:40]], 1)
    path = str(tmp_path / "bad-00000.tfrecord")
    tfrecords.write_shard(path, [tfrecords.sequence_example(good, 0), bad],
                          device=cuda)
    reader = InputReader(_cfg(variant_config, views=1), False, device=cuda)
    with pytest.raises(ValueError, match=r"bad-00000\.tfrecord: record 1"):
        list(reader(path, 1))


@pytest.mark.cuda
def test_card_training_repeats_for_a_seed(cuda, tmp_path):
    videos = [(_video(20 + i, h=64, w=80, base=i), i) for i in range(3)]
    tfrecords.write_video_array_shards(videos, str(tmp_path), prefix="t",
                                       device=cuda)
    pattern = str(tmp_path / "t-*")

    def run(threads):
        reader = InputReader(_cfg(variant_config), True, seed=3,
                             num_threads=threads, device=cuda)
        it = reader(pattern, 2)
        return [next(it) for _ in range(3)]

    for a, b in zip(run(1), run(4)):
        assert torch.equal(a["video"], b["video"])
        assert a["video"].device.type == "cuda"
        assert a["label"].device.type == "cuda"
    assert os.path.exists(glob.glob(pattern)[0])


@pytest.mark.cuda
def test_card_readers_interleaved_give_what_each_gives_alone(cuda,
                                                             tmp_path):
    """A training reader decodes its next batch on a stream of its own
    while an eval reader decodes on another (as training with validation
    does); each stream has its own nvJPEG state, so both give the batches
    they give alone."""
    videos = [(_video(20 + i, h=64, w=80, base=i), i) for i in range(6)]
    tfrecords.write_video_array_shards(videos, str(tmp_path), prefix="i",
                                       videos_per_record=2, device=cuda)
    pattern = str(tmp_path / "i-*")

    def train():
        return InputReader(_cfg(variant_config), True, seed=5,
                           device=cuda)(pattern, 2)

    def evaluate():
        return InputReader(_cfg(variant_config, 3), False,
                           device=cuda)(pattern, 1)

    it = train()
    solo_train = [next(it)["video"].clone() for _ in range(8)]
    it.close()
    solo_eval = [b["video"].clone() for b in evaluate()]
    it = train()
    mixed_train = [next(it)["video"].clone()]
    mixed_eval = []
    for b in evaluate():
        mixed_eval.append(b["video"].clone())
        mixed_train.append(next(it)["video"].clone())
    mixed_train += [next(it)["video"].clone()
                    for _ in range(8 - len(mixed_train))]
    it.close()
    assert len(solo_eval) == len(mixed_eval) == 6
    for a, b in zip(solo_eval + solo_train, mixed_eval + mixed_train):
        assert torch.equal(a, b)
