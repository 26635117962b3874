"""The port's TFRecord writer and reader against TensorFlow and the JAX
package's writer: shards the port writes read back in TensorFlow, and
shards the JAX package writes read back in the port, with the same JPEG
bytes, labels and frame counts; GZIP and plain files; a flipped byte
raises and names the shard and the record; the SequenceExample walk stops
at the frames asked for; CRC-32C against its published check value.

Tiny frames (36x48).  TensorFlow and JAX are imported inside the CPU tests,
so that the card tests (marker ``cuda``: the library's CRC-32C against the
Python one, an nvJPEG round trip through the writer and reader) collect
without them: ``python -m pytest --noconftest -m cuda
tests/test_torch_tfrecords.py``.
"""

import gzip
import os

import numpy as np
import pytest
import torch

from x3d_tpu_torch.data import tfrecords
from x3d_tpu_torch.ops import jpeg


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _video(n, h=36, w=48, base=0):
    y = np.arange(h, dtype=np.float32)[:, None, None]
    x = np.arange(w, dtype=np.float32)[None, :, None]
    return np.stack([np.broadcast_to((base * 3 + i * 5 + y * 1.5 + x) % 240,
                                     (h, w, 3)).astype(np.uint8)
                     for i in range(n)])


def _tf_read(path, compression="GZIP"):
    """[(jpeg bytes, label, num_frames)] of a shard, read by TensorFlow."""
    import tensorflow as tf

    out = []
    for rec in tf.data.TFRecordDataset(path, compression_type=compression):
        ctx, seq = tf.io.parse_single_sequence_example(
            rec,
            context_features={
                "video/num_frames": tf.io.FixedLenFeature([], tf.int64, -1),
                "video/class/label": tf.io.FixedLenFeature([], tf.int64, -1)},
            sequence_features={
                "video": tf.io.FixedLenSequenceFeature([], tf.string)})
        out.append(([bytes(b) for b in seq["video"].numpy()],
                    int(ctx["video/class/label"]),
                    int(ctx["video/num_frames"])))
    return out


def _port_read(path):
    out = []
    for rec in tfrecords.read_shard(path):
        v = tfrecords.SequenceExampleView(rec)
        out.append(([bytes(v.frame(i)) for i in range(v.stored_frames())],
                    v.label, v.num_frames))
    return out


def test_crc32c_check_value():
    assert tfrecords.crc32c_python(b"123456789") == 0xE3069283
    assert tfrecords.crc32c_python(b"") == 0


@pytest.mark.parametrize("compression", ["GZIP", None])
def test_port_shards_read_by_tensorflow(tmp_path, compression):
    videos = [(_video(5 + i, base=i), 3 * i + 1) for i in range(3)]
    path = str(tmp_path / "port.tfrecord")
    tfrecords.write_shard(
        path, (tfrecords.frames_to_sequence_example(f, l, device="cpu")
               for f, l in videos), compression=compression, device="cpu")
    if compression == "GZIP":
        with gzip.open(path) as f:        # one GZIP stream, level 9
            assert len(f.read()) > 0
    got = _tf_read(path, compression or "")
    assert got == _port_read(path)
    assert [(len(j), l, n) for j, l, n in got] == \
        [(len(f), l, len(f)) for f, l in videos]
    for jpegs, _, _ in got:
        assert all(jpeg.image_size(j) == (36, 48) for j in jpegs)


def test_jax_shards_read_by_the_port(tmp_path):
    from x3d_tpu.data.tfrecords import write_video_array_shards

    videos = [(_video(4 + i, base=2 * i), i) for i in range(5)]
    paths = write_video_array_shards(videos, str(tmp_path), prefix="jax",
                                     videos_per_record=2)
    assert len(paths) == 3
    for p in paths:
        assert _port_read(p) == _tf_read(p)


def test_port_writer_names_shards_as_jax(tmp_path):
    videos = [(_video(3, base=i), i) for i in range(5)]
    paths = tfrecords.write_video_array_shards(
        videos, str(tmp_path), prefix="val", videos_per_record=2,
        device="cpu")
    assert [os.path.basename(p) for p in paths] == [
        "val-00000.tfrecord", "val-00001.tfrecord", "val-00002.tfrecord"]
    labels = [l for p in paths for _, l, _ in _port_read(p)]
    assert labels == [0, 1, 2, 3, 4]


def _plain_shard(tmp_path, n=2):
    path = str(tmp_path / "plain.tfrecord")
    tfrecords.write_shard(
        path, (tfrecords.frames_to_sequence_example(_video(3, base=i), i,
                                                    device="cpu")
               for i in range(n)), compression=None, device="cpu")
    return path


@pytest.mark.parametrize("where", ["length", "data", "data_crc"])
def test_a_flipped_byte_raises_naming_shard_and_record(tmp_path, where):
    path = _plain_shard(tmp_path)
    raw = bytearray(open(path, "rb").read())
    (first,) = np.frombuffer(raw[:8], "<u8")
    second = 12 + int(first) + 4          # the second record's header
    pos = {"length": second + 3, "data": second + 12 + 40,
           "data_crc": len(raw) - 2}[where]
    raw[pos] ^= 0x10
    bad = str(tmp_path / "bad.tfrecord")
    open(bad, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match=r"bad\.tfrecord: record 1"):
        tfrecords.read_shard(bad)
    # the same corruption under GZIP
    gz = str(tmp_path / "bad_gz.tfrecord")
    open(gz, "wb").write(gzip.compress(bytes(raw), 9))
    with pytest.raises(ValueError, match=r"bad_gz\.tfrecord: record 1"):
        tfrecords.read_shard(gz)


def test_truncated_gzip_raises(tmp_path):
    path = str(tmp_path / "t.tfrecord")
    tfrecords.write_shard(path, [b"x" * 100], device="cpu")
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[:-6])
    with pytest.raises(ValueError, match="t.tfrecord"):
        tfrecords.read_shard(path)


def test_unset_num_frames_falls_back_to_the_stored_count():
    jpegs = jpeg.encode(_video(7), device="cpu")
    frames = b"".join(tfrecords._field(1, tfrecords._bytes_feature(j))
                      for j in jpegs)
    ex = (tfrecords._field(1, tfrecords._field(1, tfrecords._map_entry(
        tfrecords.LABEL_KEY, tfrecords._int64_feature(4))))
        + tfrecords._field(2, tfrecords._field(1, tfrecords._map_entry(
            tfrecords.FRAMES_KEY, frames))))
    v = tfrecords.SequenceExampleView(ex)
    assert (v.label, v.num_frames, v.size()) == (4, -1, 7)
    assert bytes(v.frame(6)) == jpegs[6]


def test_the_walk_stops_at_the_frames_asked_for():
    ex = tfrecords.frames_to_sequence_example(_video(9), 2, device="cpu")
    v = tfrecords.SequenceExampleView(ex)
    assert v.size() == 9 and not v._spans       # num_frames is set
    v.frame(2)
    assert len(v._spans) == 3
    with pytest.raises(ValueError, match="frame 9"):
        v.frame(9)


def test_a_record_without_frames_raises():
    with pytest.raises(ValueError, match="no 'video' frames"):
        tfrecords.SequenceExampleView(b"")


def test_a_negative_label_round_trips(tmp_path):
    path = str(tmp_path / "neg.tfrecord")
    tfrecords.write_shard(path, [tfrecords.sequence_example(
        jpeg.encode(_video(1), device="cpu"), -1)], device="cpu")
    assert [l for _, l, _ in _tf_read(path)] == [-1]
    assert [l for _, l, _ in _port_read(path)] == [-1]


@pytest.mark.cuda
def test_library_crc32c_matches_python(cuda):
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 8, 9, 1000, 65537):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert jpeg.crc32c(data) == tfrecords.crc32c_python(data)
    assert jpeg.crc32c(b"123456789") == 0xE3069283


@pytest.mark.cuda
def test_card_writer_round_trip(cuda, tmp_path):
    """Shards written on the card (nvJPEG) read back through the library's
    CRC, and decode to within JPEG's error of the frames written."""
    frames = _video(6, h=64, w=80)
    paths = tfrecords.write_video_array_shards(
        [(frames, 3)], str(tmp_path), device=cuda)
    recs = tfrecords.read_shard(paths[0], jpeg.crc32c)
    v = tfrecords.SequenceExampleView(recs[0])
    assert (v.label, v.size()) == (3, 6)
    blobs = [bytes(v.frame(i)) for i in range(6)]
    arena, offsets = jpeg.decode_batch(blobs, [(64, 80)] * 6, cuda)
    got = arena.cpu().numpy()
    for i in range(6):
        img = got[offsets[i]:offsets[i] + 64 * 80 * 3].reshape(64, 80, 3)
        err = np.abs(img.astype(int) - frames[i].astype(int))
        assert err.mean() < 2.0 and err.max() <= 24


@pytest.mark.cuda
@pytest.mark.parametrize("where", [None, "length", "data", "data_crc"])
def test_library_crc_reads_shards_as_python(cuda, tmp_path, where):
    """The pipeline's reader on the card (``crc_function``: the library's
    CRC-32C) reads what the Python CRC reads and raises where it raises."""
    path = _plain_shard(tmp_path, n=3)
    raw = bytearray(open(path, "rb").read())
    if where is not None:
        (first,) = np.frombuffer(raw[:8], "<u8")
        second = 12 + int(first) + 4
        (size,) = np.frombuffer(raw[second:second + 8], "<u8")
        pos = {"length": second + 3, "data": second + 12 + 40,
               "data_crc": second + 12 + int(size) + 1}[where]
        raw[pos] ^= 0x10
    bad = str(tmp_path / "s.tfrecord")
    open(bad, "wb").write(bytes(raw))
    crc = tfrecords.crc_function(cuda)
    assert crc is jpeg.crc32c
    if where is None:
        got = tfrecords.read_shard(bad, crc)
        assert [bytes(r) for r in got] == \
            [bytes(r) for r in tfrecords.read_shard(bad)]
    else:
        with pytest.raises(ValueError, match=r"s\.tfrecord: record 1"):
            tfrecords.read_shard(bad, crc)
