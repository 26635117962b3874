"""Raw videos in the port (``data/avi.py``, ``data/video.py``, the text-list
``InputReader`` and ``transforms.train_exact_map``) against the JAX
package's ``x3d_tpu/data/video.py``, ``InputReader(use_tfrecord=False)``
and ``SpatialTransforms``, on tiny videos (at most 64 px, a few dozen
frames) that OpenCV writes here.

* The OpenCV backend: on mp4v and MJPEG files, ``decode_all_frames``,
  ``decode_frames_sampled`` (a fixed and an eval sampler, and the full-
  decode fallback where the container overcounts) and ``video_fps`` equal
  JAX's bit for bit (the MJPEG reader set aside for these).
* The AVI reader: frame count and fps equal ``cv2.VideoCapture``'s
  (zero-length chunks, OpenDML continuations, NTSC and 12.5 fps, a
  stretched ``dwLength``); each frame's bytes are its chunk's (against
  the file's ``idx1``); Pillow's decode of them equals ``cv2.imdecode``'s
  bit for bit; a frame without Huffman tables decodes as the original;
  interlaced frames and other codecs are not taken.  The sampled frames of
  an MJPEG AVI are those OpenCV's path gives, told by a flat block's
  level (``VideoCapture`` does not decode MJPEG as libjpeg does: its
  chroma upsampling differs by up to 83 levels, so no pixel tolerance can
  hold the two together).
* Eval batches from a text list, 1 and 3 crops: labels, order and sampled
  indices equal JAX's reader; clips equal JAX's (mp4v: OpenCV in both) or
  JAX's ``eval_views`` on libjpeg's frames (MJPEG), bit for bit at uint8
  and in bfloat16 after JAX's ``device_prep``, and in float32 the port's
  own normalisation of those uint8 clips bit for bit and ``device_prep``
  within 4.8e-7 (XLA multiplies by reciprocals, PyTorch divides; the
  largest gap measured in ``tests/test_torch_clip_prep.py``).
* Training clips: ``train_exact_map`` for its own draws (jitter size, y,
  x, flip; the flip bug too) equals JAX's ``_short_side_resize``, crop and
  flip on the same frames bit for bit at uint8; the reader's training
  batches are reproducible and flip half the clips.
* Bad input: a corrupt file gives JAX's zeros, and the reader counts the
  substitution, also where only a sampled frame fails in the batch's
  decode; with no video library the port raises ImportError naming the
  three, and still reads MJPEG AVIs.
* Host sharding of a text list equals ``TextLineDataset.shard``.

Card tests (marker ``cuda``; ``python -m pytest --noconftest -m cuda
tests/test_torch_video.py``): the text path's clips equal the plain clip
prep on nvJPEG's own frames bit for bit, with MJPEG AVIs and with frames
decoded on the host (a stand-in decord, since the card machine has no
video library).
"""

import os
import struct
import sys
import types

import numpy as np
import pytest
import torch

from x3d_tpu_torch import variant_config
from x3d_tpu_torch.data import InputReader, avi, video
from x3d_tpu_torch.data import transforms
from x3d_tpu_torch.ops import clip_prep, jpeg
from x3d_tpu_torch.utils import normalize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 4
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


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _frames(n, h=36, w=48, seed=0):
    """Textured RGB frames; frame i carries the level 10 * i + 5 in a flat
    16x16 block at the top left (``_levels`` reads it back)."""
    rng = np.random.default_rng(seed)
    y = np.arange(h)[:, None, None]
    x = np.arange(w)[None, :, None]
    out = []
    for i in range(n):
        img = ((y * 3 + x * 2 + i * 11 + 40 * np.sin(x / 3 + y / 5 + i)
                + rng.integers(0, 30, (h, w, 3))) % 256).astype(np.uint8)
        img[:16, :16] = (10 * i + 5) % 250
        out.append(img)
    return np.stack(out)


def _levels(frames):
    """The frame indices that ``_frames`` wrote into decoded frames."""
    block = np.asarray(frames)[:, 4:12, 4:12].astype(np.float64)
    return np.rint((block.mean(axis=(1, 2, 3)) - 5) / 10).astype(int)


def _cv_write(path, frames, fps=30.0, fourcc="mp4v"):
    import cv2

    h, w = frames.shape[1:3]
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    assert out.isOpened()
    for f in frames:
        out.write(np.ascontiguousarray(f[..., ::-1]))
    out.release()
    return path


def _jpegs(frames):
    import cv2

    return [cv2.imencode(".jpg", np.ascontiguousarray(f[..., ::-1]))[1]
            .tobytes() for f in frames]


def _cv_count_fps(path):
    import cv2

    cap = cv2.VideoCapture(path)
    out = (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
           cap.get(cv2.CAP_PROP_FPS))
    cap.release()
    return out


def _imdecode(blob):
    import cv2

    return cv2.imdecode(np.frombuffer(bytes(blob), np.uint8),
                        cv2.IMREAD_COLOR)[..., ::-1]


def _set_length(path, n):
    """Overwrite the video stream's ``strh.dwLength``."""
    data = bytearray(open(path, "rb").read())
    at = data.find(b"strh") + 8 + 32
    struct.pack_into("<I", data, at, n)
    open(path, "wb").write(bytes(data))


class _Fixed:
    """A sampler of fixed frames (``k * rate + start`` modulo the size),
    callable by both packages' decoders."""

    def __init__(self, k=5, rate=3, start=1):
        self.k, self.rate, self.start = k, rate, start

    def indices(self, size, rng=None):
        return (np.arange(self.k) * self.rate + self.start) % size


# ------------------------------------------------- (a) the OpenCV backend

@pytest.mark.parametrize("fourcc,ext,fps", [("mp4v", "mp4", 12.5),
                                            ("MJPG", "avi", 30.0)])
def test_opencv_backend_equals_jax(tmp_path, monkeypatch, fourcc, ext, fps):
    from x3d_tpu.data import transforms as jax_transforms
    from x3d_tpu.data import video as jax_video

    path = _cv_write(str(tmp_path / f"v.{ext}"), _frames(23), fps, fourcc)
    # the OpenCV backend alone: the port takes MJPEG AVIs itself otherwise
    monkeypatch.setattr(video, "open_mjpeg", lambda p: None)
    assert video.available_backend() == jax_video.available_backend() \
        == "opencv"
    assert video.video_fps(path) == jax_video.video_fps(path) == fps
    want = jax_video.decode_all_frames(path)
    got = video.decode_all_frames(path, device="cpu")
    assert got.dtype == np.uint8 and want.shape == (23, 36, 48, 3)
    np.testing.assert_array_equal(got, want)
    samplers = [(_Fixed(), _Fixed()),
                (transforms.TemporalSampler(False, 5, T, 3),
                 jax_transforms.TemporalSampler(False, 5, T, 3))]
    for port_s, jax_s in samplers:
        got = video.decode_frames_sampled(path, port_s, device="cpu")
        np.testing.assert_array_equal(got.frames,
                                      jax_video.decode_frames_sampled(path,
                                                                      jax_s))
        assert not got.substituted


def test_opencv_fallback_where_the_count_overcounts(tmp_path, monkeypatch):
    """dwLength 40 for 23 frames: both packages decode everything and
    sample again over what they got (JAX ``video.py:190-197``)."""
    from x3d_tpu.data import video as jax_video

    path = _cv_write(str(tmp_path / "v.avi"), _frames(23), 30.0, "MJPG")
    _set_length(path, 40)
    assert _cv_count_fps(path)[0] == 40
    monkeypatch.setattr(video, "open_mjpeg", lambda p: None)
    sampler = _Fixed(k=6, rate=7)          # reaches past frame 22 of 40
    got = video.decode_frames_sampled(path, sampler, device="cpu")
    want = jax_video.decode_frames_sampled(path, sampler)
    np.testing.assert_array_equal(got.frames, want)
    np.testing.assert_array_equal(got.indices, sampler.indices(23))


# ----------------------------------------------------- (b) the AVI reader

def _crafted(tmp_path, name, jpegs, **kw):
    path = str(tmp_path / name)
    _chip_smoke().write_mjpeg_avi(path, jpegs, 48, 36, **kw)
    return path


@pytest.mark.parametrize("case", ["plain", "zero_first", "zero_middle",
                                  "zero_last", "two_zero", "avix",
                                  "avix_zero", "ntsc", "pal_half"])
def test_avi_reader_counts_and_frames_as_opencv(tmp_path, case):
    import cv2

    jp = _jpegs(_frames(9))
    kw = {}
    jpegs = {"plain": jp, "zero_first": [b""] + jp,
             "zero_middle": jp[:4] + [b""] + jp[4:],
             "zero_last": jp + [b""], "two_zero": jp[:2] + [b"", b""] + jp[2:],
             "avix": jp, "avix_zero": jp[:3] + [b""] + jp[3:],
             "ntsc": jp, "pal_half": jp}[case]
    if case.startswith("avix"):
        kw["avix_at"] = 5
    if case == "ntsc":
        kw.update(rate=30000, scale=1001)
    if case == "pal_half":
        kw.update(rate=25, scale=2)
    path = _crafted(tmp_path, f"{case}.avi", jpegs, **kw)
    a = avi.open_mjpeg(path)
    assert (a.count, a.fps) == _cv_count_fps(path)
    assert a.count == len(jpegs) and len(a) == 9
    assert [bytes(a.frame(i)) for i in range(len(a))] == jp
    # what VideoCapture returns: one frame a chunk that holds data
    cap = cv2.VideoCapture(path)
    got = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        got.append(f[..., ::-1])
    cap.release()
    assert list(_levels(got)) == list(range(9))
    arena, offsets = jpeg.decode_batch([a.jpeg(i) for i in range(9)],
                                       [(36, 48)] * 9, "cpu")
    for i, o in enumerate(offsets):
        np.testing.assert_array_equal(
            arena[o:o + 36 * 48 * 3].view(36, 48, 3).numpy(),
            _imdecode(a.frame(i)))


def test_avi_reader_on_opencv_files(tmp_path):
    """An MJPEG AVI that OpenCV (libavformat) writes: count, fps, and each
    frame's bytes at the offsets of the file's own idx1 index."""
    path = _cv_write(str(tmp_path / "cv.avi"), _frames(11), 15.0, "MJPG")
    a = avi.open_mjpeg(path)
    assert (a.count, a.fps) == _cv_count_fps(path) == (11, 15.0)
    data = open(path, "rb").read()
    movi = data.find(b"movi")
    idx1 = data.find(b"idx1")
    (n,) = struct.unpack_from("<I", data, idx1 + 4)
    spans = []
    for k in range(n // 16):
        cid, _, off, size = struct.unpack_from("<4sIII", data, idx1 + 8
                                               + 16 * k)
        if cid == b"00dc":
            spans.append(data[movi + off + 8:movi + off + 8 + size])
    assert [bytes(a.frame(i)) for i in range(len(a))] == spans
    for i in range(len(a)):
        np.testing.assert_array_equal(
            video.decode_jpegs(a, [i], "cpu")[0], _imdecode(a.frame(i)))


def _strip_dht(blob):
    out, pos = bytearray(blob[:2]), 2
    while True:
        marker = blob[pos + 1]
        n = blob[pos + 2] << 8 | blob[pos + 3]
        if marker == 0xDA:
            return bytes(out + blob[pos:])
        if marker != 0xC4:
            out += blob[pos:pos + 2 + n]
        pos += 2 + n


def test_frames_without_huffman_tables(tmp_path):
    """Camera MJPEG leaves out the standard tables: the reader inserts
    ITU T.81 Annex K.3's, and the frame decodes as the original did."""
    jp = _jpegs(_frames(3))
    bare = [_strip_dht(j) for j in jp]
    assert all(b"\xff\xc4" not in b[:b.find(b"\xff\xda")] for b in bare)
    path = _crafted(tmp_path, "bare.avi", bare)
    a = avi.open_mjpeg(path)
    for i, j in enumerate(jp):
        fixed = a.jpeg(i)
        assert b"\xff\xc4" in fixed and bytes(a.frame(i)) == bare[i]
        np.testing.assert_array_equal(
            video.decode_jpegs(a, [i], "cpu")[0], _imdecode(j))
    assert avi.with_huffman_tables(jp[0]) is jp[0]
    # the tables are libjpeg's defaults, which Pillow writes
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(_frames(1)[0]).save(buf, format="JPEG")
    blob = buf.getvalue()
    tables = []
    pos = 2
    while blob[pos + 1] != 0xDA:
        n = blob[pos + 2] << 8 | blob[pos + 3]
        if blob[pos + 1] == 0xC4:
            tables.append(blob[pos + 4:pos + 2 + n])
        pos += 2 + n
    assert b"".join(tables) == avi.STD_DHT[4:]


def _with_avi1(blob, polarity):
    app0 = b"\xff\xe0" + struct.pack(">H", 16) + b"AVI1" + bytes(
        [polarity]) + bytes(9)
    return blob[:2] + app0 + blob[2:]


def test_what_is_not_mjpeg_goes_to_the_host(tmp_path):
    jp = _jpegs(_frames(4))
    progressive = _crafted(tmp_path, "avi1.avi",
                           [_with_avi1(j, 0) for j in jp])
    assert len(avi.open_mjpeg(progressive)) == 4
    fields = _crafted(tmp_path, "fields.avi", [_with_avi1(j, 1) for j in jp])
    assert avi.open_mjpeg(fields) is None
    half = str(tmp_path / "half.avi")
    _chip_smoke().write_mjpeg_avi(half, jp, 48, 72)       # 36 = 72 / 2
    assert avi.open_mjpeg(half) is None
    mp4v_avi = _cv_write(str(tmp_path / "mp4v.avi"), _frames(4), 30.0, "mp4v")
    assert avi.open_mjpeg(mp4v_avi) is None
    mp4 = _cv_write(str(tmp_path / "v.mp4"), _frames(4), 30.0, "mp4v")
    assert avi.open_mjpeg(mp4) is None
    text = tmp_path / "list.txt"
    text.write_text("nothing here\n")
    assert avi.open_mjpeg(str(text)) is None
    assert video.open_mjpeg(str(tmp_path / "missing.avi")) is None


@pytest.mark.parametrize("case", ["plain", "zero_middle", "overcount",
                                  "no_length"])
def test_mjpeg_sampling_follows_opencv(tmp_path, case):
    """The frames an MJPEG AVI's sampled decode gives are the ones JAX's
    OpenCV path gives (told apart by their level), with zero-length chunks
    counted but not returned, and the full-decode fallback where the
    count is more than the frames (or 0)."""
    from x3d_tpu.data import transforms as jax_transforms
    from x3d_tpu.data import video as jax_video

    jp = _jpegs(_frames(13))
    jpegs = jp[:6] + [b""] + jp[6:] if case == "zero_middle" else jp
    path = _crafted(tmp_path, f"{case}.avi", jpegs)
    if case == "overcount":
        _set_length(path, 30)
    if case == "no_length":
        _set_length(path, 0)
    for port_s, jax_s in ((_Fixed(k=5, rate=3, start=0), _Fixed(5, 3, 0)),
                          (transforms.TemporalSampler(False, 5, T, 3),
                           jax_transforms.TemporalSampler(False, 5, T, 3))):
        got = video.decode_frames_sampled(path, port_s, device="cpu")
        want = jax_video.decode_frames_sampled(path, jax_s)
        assert got.frames.shape == want.shape and not got.substituted
        np.testing.assert_array_equal(_levels(got.frames), _levels(want))
        np.testing.assert_array_equal(_levels(got.frames),
                                      got.indices.ravel())
    a = avi.open_mjpeg(path)
    assert video.video_fps(path) == jax_video.video_fps(path) == a.fps
    np.testing.assert_array_equal(
        _levels(video.decode_all_frames(path, device="cpu")),
        _levels(jax_video.decode_all_frames(path)))


# --------------------------------- (c) eval batches from a text list


def _list(tmp_path):
    """Two mp4v and two MJPEG videos (one of each tall), labels 3 2 1 0."""
    d = tmp_path
    rows = [
        (_cv_write(str(d / "a.mp4"), _frames(21, seed=1), 25.0), 3),
        (_cv_write(str(d / "b.avi"), _frames(17, 48, 36, seed=2), 30.0,
                   "MJPG"), 2),
        (_cv_write(str(d / "c.mp4"), _frames(9, 48, 36, seed=3), 10.0), 1),
        (_cv_write(str(d / "d.avi"), _frames(30, seed=4), 12.5, "MJPG"), 0),
    ]
    path = d / "list.txt"
    path.write_text("".join(f"{p} {l}\n" for p, l in rows))
    return str(path), rows


def _cfg(make, crops, views=3):
    cfg = make("XS")
    cfg.DATA.TRAIN_JITTER_SCALES = [36, 44]
    cfg.DATA.TRAIN_CROP_SIZE = 32
    cfg.DATA.TEST_CROP_SIZE = 32
    cfg.DATA.TEMP_DURATION = T
    cfg.DATA.MEAN, cfg.DATA.STD = list(MEAN), list(STD)
    cfg.TEST.NUM_TEMPORAL_VIEWS = views
    cfg.TEST.NUM_SPATIAL_CROPS = crops
    return cfg


def _libjpeg_clips(path, cfg_jax):
    """JAX's eval geometry on an MJPEG AVI's frames as libjpeg decodes
    them, at JAX's sampled indices over OpenCV's count."""
    import tensorflow as tf

    from x3d_tpu.data import transforms as jax_transforms

    a = avi.open_mjpeg(path)
    frames = np.stack([_imdecode(a.frame(i)) for i in range(len(a))])
    sampler = jax_transforms.TemporalSampler(
        False, cfg_jax.DATA.FRAME_RATE, T, cfg_jax.TEST.NUM_TEMPORAL_VIEWS)
    idx = sampler.indices(_cv_count_fps(path)[0]).numpy()
    st = jax_transforms.SpatialTransforms(
        0, 0, cfg_jax.DATA.TEST_CROP_SIZE, False,
        num_crops=cfg_jax.TEST.NUM_SPATIAL_CROPS)
    views = sampler.reshape_views(tf.constant(frames[idx]))
    return tf.cast(st.eval_views(views), tf.uint8).numpy(), idx


@pytest.mark.parametrize("crops", [1, 3])
def test_eval_batches_equal_jax(tmp_path, crops):
    import jax.numpy as jnp

    from x3d_tpu import variant_config as jax_config
    from x3d_tpu.data import transforms as jax_transforms
    from x3d_tpu.data.device import device_prep
    from x3d_tpu.data.pipeline import InputReader as JaxReader

    listing, rows = _list(tmp_path)
    cfg_jax = _cfg(jax_config, crops)
    want = list(JaxReader(cfg_jax, is_training=False, use_tfrecord=False)
                .as_numpy(listing, 2))
    per = 3 * crops
    reader = InputReader(_cfg(variant_config, crops), False, device="cpu",
                         dtype=torch.uint8, use_tfrecord=False)
    reader.keep_last = True
    got, records = [], []
    for b in reader(listing, 2):
        got.append({k: v.numpy() for k, v in b.items()})
        records.extend(reader.last.records)
    assert len(got) == len(want) == 2 and reader.substituted == 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["label"], w["label"])
    labels = [l for _, l in rows]
    assert [int(l) for g in got for l in g["label"]] == labels
    cfg = _cfg(variant_config, crops)
    normed = {dtype: [b["video"].to(torch.float32).numpy() for b in
                      InputReader(cfg, False, device="cpu", dtype=dtype,
                                  use_tfrecord=False)(listing, 2)]
              for dtype in (torch.bfloat16, torch.float32)}
    for k, ((path, _), rec) in enumerate(zip(rows, records)):
        b, j = divmod(k, 2)
        part = slice(j * per, (j + 1) * per)
        if path.endswith(".avi"):
            ref, idx = _libjpeg_clips(path, cfg_jax)
        else:
            ref = want[b]["video"][part]
            idx = jax_transforms.TemporalSampler(False, 5, T, 3).indices(
                _cv_count_fps(path)[0]).numpy()
        np.testing.assert_array_equal(rec.indices, idx)
        np.testing.assert_array_equal(got[b]["video"][part], ref)
        np.testing.assert_array_equal(
            normed[torch.bfloat16][b][part],
            np.asarray(device_prep(cfg_jax, jnp.bfloat16)(ref)
                       .astype(jnp.float32)))
        out = normed[torch.float32][b][part]
        np.testing.assert_array_equal(
            out, normalize(torch.from_numpy(ref.copy()), MEAN, STD).numpy())
        np.testing.assert_allclose(
            out, np.asarray(device_prep(cfg_jax, jnp.float32)(ref)),
            rtol=0, atol=4.8e-7)


# ----------------------------------------------------- (d) training clips

@pytest.mark.parametrize("h,w", [(36, 48), (48, 36), (36, 36)])
@pytest.mark.parametrize("flip_mode", [1, 2])
def test_train_exact_map_equals_jax(h, w, flip_mode):
    import tensorflow as tf

    from x3d_tpu.data import transforms as jax_transforms

    frames = np.stack([_imdecode(j) for j in _jpegs(_frames(3, h, w))])
    n, crop = len(frames), 32
    offsets, total = jpeg.arena_layout([(h, w)] * n)
    arena = torch.zeros(total, dtype=torch.uint8)
    for f, off in zip(frames, offsets):
        arena[off:off + f.size] = torch.from_numpy(f.reshape(-1))
    st = jax_transforms.SpatialTransforms(36, 44, crop, True)
    flips = set()
    for k in range(12):
        m = transforms.train_exact_map(h, w, crop, 36, 44,
                                       transforms.record_rng(0, 0, k),
                                       flip_mode)
        # the same draws, in the map's order
        rng = transforms.record_rng(0, 0, k)
        size = np.float32(rng.uniform(36, 44))
        new_h, new_w, _ = transforms.short_side_size(h, w, size)
        y = int(rng.integers(0, new_h - crop + 1))
        x = int(rng.integers(0, new_w - crop + 1))
        flip = flip_mode == 2 or rng.random() < 0.5
        np.testing.assert_array_equal(
            m, transforms.exact_map(h, w, crop, size, y, x, flip))
        flips.add(flip)
        ref = st._short_side_resize(tf.constant(frames), tf.constant(size))
        ref = ref[:, y:y + crop, x:x + crop, :]
        if flip:
            ref = tf.image.flip_left_right(ref)
        ref = tf.cast(ref, tf.uint8).numpy()
        rows = np.repeat(m, n)
        rows["src"] = offsets
        rows["pitch"] = w * 3
        got = clip_prep.clip_prep(arena, rows, (1, n, crop, crop, 3),
                                  torch.uint8)
        np.testing.assert_array_equal(got[0].numpy(), ref)
    assert flips == ({True} if flip_mode == 2 else {True, False})


def test_training_batches_from_a_text_list(tmp_path):
    listing, rows = _list(tmp_path)
    cfg = _cfg(variant_config, 1)

    def batches(seed, threads, flip_bug=False):
        r = InputReader(cfg, True, seed=seed, device="cpu", dtype=torch.uint8,
                        use_tfrecord=False, num_threads=threads,
                        replicate_flip_bug=flip_bug)
        r.keep_last = True
        out = []
        it = r(listing, 2)
        for _ in range(6):            # three epochs of two batches
            b = next(it)
            out.append((b["video"].numpy(), b["label"].tolist(),
                        [int(f) for f in r.last.table["flip"][::T]]))
        it.close()
        return out

    a, b = batches(0, 1), batches(0, 3)
    assert all(np.array_equal(x[0], y[0]) and x[1:] == y[1:]
               for x, y in zip(a, b))
    labels = [x[1] for x in a]
    for e in range(3):                 # each epoch every video once
        assert sorted(labels[2 * e] + labels[2 * e + 1]) == [0, 1, 2, 3]
    assert [x[0].tobytes() for x in batches(1, 1)] \
        != [x[0].tobytes() for x in a]
    assert {f for x in a for f in x[2]} == {0, 1}
    assert {f for x in batches(0, 1, True) for f in x[2]} == {1}
    assert a[0][0].shape == (2, T, 32, 32, 3)


# ------------------------------------------------------- (e) bad input

def test_a_corrupt_video_gives_jax_zeros_and_is_counted(tmp_path):
    from x3d_tpu.data import transforms as jax_transforms
    from x3d_tpu.data import video as jax_video

    bad = tmp_path / "bad.mp4"
    bad.write_bytes(b"\x00" * 1000)
    jax_s = jax_transforms.TemporalSampler(False, 5, T, 3)
    port_s = transforms.TemporalSampler(False, 5, T, 3)
    want = jax_video.decode_frames_sampled(str(bad), jax_s)
    got = video.decode_frames_sampled(str(bad), port_s, device="cpu")
    assert got.substituted and want.shape == (3 * T, 240, 144, 3)
    np.testing.assert_array_equal(got.frames, want)
    np.testing.assert_array_equal(video.decode_all_frames(str(bad), "cpu"),
                                  jax_video.decode_all_frames(str(bad)))
    # an AVI whose header says MJPEG but whose frames are not JPEGs
    broken = _crafted(tmp_path, "broken.avi", [b"\xff\xd8nonsense"] * 5)
    listing, rows = _list(tmp_path)
    lines = open(listing).read().splitlines()
    with open(listing, "w") as f:
        f.write("\n".join([f"{bad} 7", lines[0], f"{broken} 6", lines[1]])
                + "\n")
    reader = InputReader(_cfg(variant_config, 1), False, device="cpu",
                         dtype=torch.uint8, use_tfrecord=False)
    out = list(reader(listing, 2))
    assert reader.substituted == 2
    assert [b["label"].tolist() for b in out] == [[7, 3], [6, 2]]
    assert not out[0]["video"][:3].any() and not out[1]["video"][:3].any()
    assert out[0]["video"][3:].any()


def test_a_frame_that_does_not_decode_gives_zeros(tmp_path):
    """An MJPEG AVI whose headers parse but one of whose sampled frames
    (3 of 0, 3, 6, 9) is cut short: the batch's decode names the frame, and
    the reader plans that video again as zeros (counted) instead of
    failing the batch."""
    jp = _jpegs(_frames(12))
    cut = [j if k != 3 else j[:len(j) // 2] for k, j in enumerate(jp)]
    broken = _crafted(tmp_path, "cut.avi", cut)
    good = _crafted(tmp_path, "good.avi", jp)
    listing = tmp_path / "list.txt"
    listing.write_text(f"{good} 1\n{broken} 2\n")
    with pytest.raises(jpeg.DecodeError) as e:
        jpeg.decode_batch([jp[0], cut[3]], [(36, 48)] * 2, "cpu")
    assert e.value.index == 1
    reader = InputReader(_cfg(variant_config, 1, views=1), False,
                         device="cpu", dtype=torch.uint8, use_tfrecord=False)
    (batch,) = list(reader(str(listing), 2))
    assert reader.substituted == 1 and batch["label"].tolist() == [1, 2]
    assert batch["video"][0].any() and not batch["video"][1].any()


def test_without_a_video_library_the_port_names_them(tmp_path, monkeypatch):
    mp4 = _cv_write(str(tmp_path / "v.mp4"), _frames(5), 30.0)
    mjpeg = _cv_write(str(tmp_path / "v.avi"), _frames(5), 30.0, "MJPG")
    for name in ("decord", "cv2", "imageio", "imageio.v3"):
        monkeypatch.setitem(sys.modules, name, None)
    assert video.available_backend() is None
    sampler = transforms.TemporalSampler(False, 1, T, 1)
    for fn in (lambda: video.decode_all_frames(mp4, device="cpu"),
               lambda: video.decode_frames_sampled(mp4, sampler,
                                                   device="cpu")):
        with pytest.raises(ImportError,
                           match="decord.*opencv.*imageio.*Motion-JPEG"):
            fn()
    got = video.decode_frames_sampled(mjpeg, sampler, device="cpu")
    assert got.frames.shape == (T, 36, 48, 3) and not got.substituted
    assert video.video_fps(mjpeg) == 30.0


# ------------------------------------------------------ (f) host sharding

@pytest.mark.parametrize("count", [1, 2, 3])
def test_host_sharding_equals_jax(tmp_path, count):
    import tensorflow as tf

    listing = tmp_path / "list.txt"
    listing.write_text("".join(f"/v/{k}.avi {k % 4}\n" for k in range(7)))
    for host in range(count):
        want = [ln.decode() for ln in tf.data.TextLineDataset(str(listing))
                .shard(count, host).as_numpy_iterator()]
        reader = InputReader(_cfg(variant_config, 1), False, device="cpu",
                             use_tfrecord=False, host_id=host,
                             host_count=count)
        got = reader.lines(str(listing))
        assert [f"{p} {l}" for (p, l), _ in got] == want
        train = InputReader(_cfg(variant_config, 1), True, device="cpu",
                            use_tfrecord=False, host_id=host,
                            host_count=count)
        order = [line for line, *_ in
                 _take(train._video_records(got), 2 * len(got))]
        assert sorted(order[:len(got)]) == sorted(order[len(got):]) \
            == sorted(line for line, _ in got)


def _take(it, n):
    return [x for _, x in zip(range(n), it)]


def test_a_malformed_line_is_named(tmp_path):
    listing = tmp_path / "list.txt"
    listing.write_text("/v/a.avi 1\n/v/b.avi\n")
    reader = InputReader(_cfg(variant_config, 1), False, device="cpu",
                         use_tfrecord=False)
    with pytest.raises(ValueError, match="list.txt:2"):
        reader.lines(str(listing))


# --------------------------------------------------------- (g) the card

def _decord_standin(frames):
    """A decord module whose reader serves ``frames`` for any path."""
    class _Batch:
        def __init__(self, arr):
            self._arr = arr

        def asnumpy(self):
            return self._arr

    class _VideoReader:
        def __init__(self, path, ctx=None):
            self.frames = frames[path]

        def __len__(self):
            return len(self.frames)

        def get_batch(self, indices):
            return _Batch(self.frames[np.asarray(indices)])

    mod = types.ModuleType("decord")
    mod.VideoReader = _VideoReader
    mod.cpu = lambda i: ("cpu", i)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("training", [False, True])
def test_text_path_on_card_equals_plain_clip_prep(cuda, tmp_path,
                                                  monkeypatch, training):
    write = _chip_smoke().write_mjpeg_avi
    enc = lambda fs: jpeg.encode(fs, 90, device="cpu")  # noqa: E731
    rows, hosted = [], {}
    for k, (n, h, w) in enumerate([(21, 36, 48), (17, 48, 36), (30, 40, 64),
                                   (12, 36, 48)]):
        frames = _frames(n, h, w, seed=k)
        path = str(tmp_path / f"v{k}.avi")
        if k == 3:                    # decoded on the host
            path = str(tmp_path / "host.mp4")
            hosted[path] = frames
        else:
            write(path, enc(frames), w, h, avix_at=7 if k == 2 else None)
        rows.append(f"{path} {k}")
    listing = tmp_path / "list.txt"
    listing.write_text("\n".join(rows) + "\n")
    monkeypatch.setitem(sys.modules, "decord", _decord_standin(hosted))
    cfg = _cfg(variant_config, 1 if training else 3)
    reader = InputReader(cfg, training, device=cuda, dtype=torch.bfloat16,
                         use_tfrecord=False)
    reader.keep_last = True
    it = reader(str(listing), 2)
    for _ in range(2):
        out = next(it)
        plan = reader.last
        T_ = cfg.DATA.TEMP_DURATION
        S = out["video"].shape[2]
        shape = (len(plan.table) // T_, T_, S, S, 3)
        ref = clip_prep.clip_prep_reference(plan.arena, plan.table, shape,
                                            torch.bfloat16, MEAN, STD)
        assert torch.equal(out["video"], ref)
        u8 = clip_prep.clip_prep_reference(plan.arena, plan.table, shape,
                                           torch.uint8)
        assert torch.equal(clip_prep.clip_prep(plan.arena, plan.table, shape,
                                               torch.uint8), u8)
        # each clip frame reads the frame the plan sampled
        for r in plan.records:
            if r.frames is not None:
                np.testing.assert_array_equal(
                    _levels(r.frames)[r.slots], r.indices)
        assert sorted(out["label"].tolist()) == sorted(
            r.label for r in plan.records)
    it.close()
    assert reader.substituted == 0
