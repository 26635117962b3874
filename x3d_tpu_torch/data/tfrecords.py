"""TFRecord shards of SequenceExamples of JPEG frames: writer and reader.

The counterpart of the JAX package's ``x3d_tpu/data/tfrecords.py`` writer
(``frames_to_sequence_example``, ``write_shard``,
``write_video_array_shards``) and of the reader in its C++ clip loader
(``x3d_tpu/native/clip_loader.cc``: ``RecordReader`` and the hand-rolled
SequenceExample walk), without TensorFlow or protobuf.

The schema is the JAX package's, which is the reference's: one
``tf.train.SequenceExample`` per video, context ``video/num_frames`` and
``video/class/label`` (int64), feature list ``video`` of one JPEG string a
frame (quality 90), GZIP level 9 shards.  Shards written here read back in
TensorFlow and the reverse (``tests/test_torch_tfrecords.py``).

TFRecord framing: little-endian uint64 length, its masked CRC-32C, the
data, the data's masked CRC-32C.  Both CRCs are checked on read; a
mismatch raises and names the shard and the record.  The CRC runs in the
JPEG library's host code on the card (``ops/jpeg.crc32c``) and in Python
on the CPU, where it takes about a second a megabyte, which is fine for the
tests' shards and not for real ones.  The SequenceExample walk is Python's
on both.

JPEG encoding goes through ``ops/jpeg.encode``: nvJPEG for frames on a
CUDA device, Pillow for frames on the CPU (with TensorFlow's JFIF
density, so its bytes are the JAX writer's).

The offline tools of the JAX module (``x3d_tpu/data/tfrecords.py:96-292``)
are here too: :func:`create_tfrecords` (videos of a label file into shards,
each trimmed to its first TRIM_SECONDS), the label-file makers
(:func:`create_label_file`, :func:`create_test_label_file`,
:func:`build_label_map`, :func:`resolve_test_labels`), the Kinetics-400
metadata (``x3d_tpu_torch/datasets/kinetics400/``, byte-identical copies
of the JAX package's) and :func:`inspect_tfrecords`.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import zlib
from typing import (Dict, Iterable, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np

log = logging.getLogger(__name__)

JPEG_QUALITY = 90          # the JAX writer's (tfrecords.py:29)
TRIM_SECONDS = 10          # the JAX writer's (tfrecords.py:30)
GZIP_LEVEL = 9
FRAMES_KEY = b"video"
LABEL_KEY = b"video/class/label"
NUM_FRAMES_KEY = b"video/num_frames"

_MASK_DELTA = 0xA282EAD8


# ------------------------------------------------------------------ CRC-32C

def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _crc_table()


def crc32c_python(data) -> int:
    """CRC-32C (Castagnoli) of ``data``, one byte at a time."""
    crc = 0xFFFFFFFF
    table = _TABLE
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc_function(device):
    """The CRC-32C to use for a pipeline on ``device``: the JPEG library's
    host code for a CUDA device, Python for the CPU."""
    if device is not None and str(device).startswith("cuda"):
        from x3d_tpu_torch.ops import jpeg

        return jpeg.crc32c
    return crc32c_python


def masked_crc(crc: int) -> int:
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


# ------------------------------------------------------------ proto writing

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, payload: bytes) -> bytes:
    """A length-delimited field (wire type 2)."""
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _int64_feature(v: int) -> bytes:
    # Feature { int64_list = 3 { repeated int64 value = 1 [packed] } }
    return _field(3, _field(1, _varint(int(v) & 0xFFFFFFFFFFFFFFFF)))


def _bytes_feature(v: bytes) -> bytes:
    # Feature { bytes_list = 1 { repeated bytes value = 1 } }
    return _field(1, _field(1, v))


def _map_entry(key: bytes, value: bytes) -> bytes:
    return _field(1, key) + _field(2, value)


def sequence_example(jpegs: Sequence[bytes], label: int) -> bytes:
    """Serialise JPEG frames and a label as the schema's SequenceExample."""
    context = (_field(1, _map_entry(NUM_FRAMES_KEY,
                                    _int64_feature(len(jpegs))))
               + _field(1, _map_entry(LABEL_KEY, _int64_feature(label))))
    frames = b"".join(_field(1, _bytes_feature(j)) for j in jpegs)
    feature_lists = _field(1, _map_entry(FRAMES_KEY, frames))
    return _field(1, context) + _field(2, feature_lists)


def frames_to_sequence_example(frames, label: int, device=None) -> bytes:
    """Serialise (N, H, W, 3) uint8 frames (numpy or a tensor) as the
    schema's SequenceExample, each frame a quality-90 JPEG.  Encoded on
    ``device``: CUDA unless the caller asks for the CPU."""
    from x3d_tpu_torch.ops import jpeg

    return sequence_example(jpeg.encode(frames, JPEG_QUALITY, device=device),
                            label)


def frame_record(data: bytes, crc=crc32c_python) -> bytes:
    """One TFRecord: length, masked CRC of the length, data, masked CRC."""
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc(crc(length))) + data
            + struct.pack("<I", masked_crc(crc(data))))


def write_shard(path: str, examples: Iterable[bytes],
                compression: Optional[str] = "GZIP", device=None) -> int:
    """Write serialised examples to one TFRecord shard (GZIP level 9, or
    plain with ``compression=None``); returns the count."""
    crc = crc_function(device)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = 0
    with open(path, "wb") as f:
        deflate = zlib.compressobj(GZIP_LEVEL, zlib.DEFLATED, 31) \
            if compression == "GZIP" else None
        for ex in examples:
            rec = frame_record(ex, crc)
            f.write(deflate.compress(rec) if deflate else rec)
            n += 1
        if deflate:
            f.write(deflate.flush())
    return n


def write_video_array_shards(videos: Sequence[Tuple[np.ndarray, int]],
                             out_dir: str, prefix: str = "train",
                             videos_per_record: int = 32,
                             device=None) -> List[str]:
    """Write in-memory (frames, label) videos into shards named as the JAX
    writer names them (``<prefix>-00000.tfrecord``, ...)."""
    paths = []
    for start in range(0, len(videos), videos_per_record):
        chunk = videos[start:start + videos_per_record]
        path = os.path.join(
            out_dir, f"{prefix}-{start // videos_per_record:05d}.tfrecord")
        write_shard(path, (frames_to_sequence_example(f, l, device=device)
                           for f, l in chunk), device=device)
        paths.append(path)
    return paths


# ------------------------------------------------------------------ reading

def inflate(path: str) -> bytes:
    """A shard's bytes, inflated where it is GZIP (told apart by the GZIP
    magic)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:2] == b"\x1f\x8b":
        parts = []
        while raw:
            d = zlib.decompressobj(31)
            parts.append(d.decompress(raw))
            if not d.eof:
                raise ValueError(f"{path}: truncated GZIP stream")
            raw = d.unused_data
        buf = b"".join(parts) if len(parts) > 1 else parts[0]
    else:
        buf = raw
    return buf


def split_records(buf: bytes, path: str,
                  crc=crc32c_python) -> List[memoryview]:
    """Every record of an inflated shard, as views into ``buf``, both CRCs
    checked by ``crc``; an error names ``path`` and the record."""
    view = memoryview(buf)
    records = []
    pos, end = 0, len(buf)
    while pos < end:
        if pos + 12 > end:
            raise ValueError(f"{path}: record {len(records)}: truncated "
                             "header")
        (length,) = struct.unpack_from("<Q", buf, pos)
        (len_crc,) = struct.unpack_from("<I", buf, pos + 8)
        if masked_crc(crc(view[pos:pos + 8])) != len_crc:
            raise ValueError(f"{path}: record {len(records)}: length CRC "
                             "mismatch")
        start = pos + 12
        stop = start + length
        if stop + 4 > end:
            raise ValueError(f"{path}: record {len(records)}: truncated "
                             "data")
        (data_crc,) = struct.unpack_from("<I", buf, stop)
        data = view[start:stop]
        if masked_crc(crc(data)) != data_crc:
            raise ValueError(f"{path}: record {len(records)}: data CRC "
                             "mismatch")
        records.append(data)
        pos = stop + 4
    return records


def read_shard(path: str, crc=crc32c_python) -> List[memoryview]:
    """Every record of a shard (GZIP or plain), as views into one buffer,
    both CRCs checked by ``crc``."""
    return split_records(inflate(path), path, crc)


def _read_varint(buf, pos: int, end: int) -> Tuple[int, int]:
    v = shift = 0
    while pos < end:
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7
    raise ValueError("malformed proto: truncated varint")


def _fields(buf, pos: int, end: int) -> Iterator[Tuple[int, int, int, int]]:
    """(field number, wire type, start, end) of each field in buf[pos:end];
    start/end bound a length-delimited payload, or the value for others."""
    while pos < end:
        tag, pos = _read_varint(buf, pos, end)
        num, wire = tag >> 3, tag & 7
        if wire == 2:
            n, pos = _read_varint(buf, pos, end)
            start, pos = pos, pos + n
        elif wire == 0:
            start = pos
            _, pos = _read_varint(buf, pos, end)
        elif wire == 1:
            start, pos = pos, pos + 8
        elif wire == 5:
            start, pos = pos, pos + 4
        else:
            raise ValueError(f"malformed proto: wire type {wire}")
        if pos > end:
            raise ValueError("malformed proto: field overruns")
        yield num, wire, start, pos


def _map_entry_of(buf, start: int, end: int):
    key = value = None
    for num, wire, s, e in _fields(buf, start, end):
        if num == 1 and wire == 2:
            key = bytes(buf[s:e])
        elif num == 2 and wire == 2:
            value = (s, e)
    return key, value


def _int64_of(buf, start: int, end: int) -> int:
    for num, wire, s, e in _fields(buf, start, end):
        if num == 3 and wire == 2:                      # int64_list
            for n2, w2, s2, e2 in _fields(buf, s, e):
                if n2 == 1 and w2 == 2 and e2 > s2:     # packed
                    v, _ = _read_varint(buf, s2, e2)
                elif n2 == 1 and w2 == 0:
                    v, _ = _read_varint(buf, s2, e2)
                else:
                    continue
                return v - (1 << 64) if v >= 1 << 63 else v
    return -1


class SequenceExampleView:
    """The schema's fields of one serialised SequenceExample, read without
    copying: ``label`` and ``num_frames`` (-1 where unset), and the byte
    spans of the ``video`` frames, walked only as far as asked."""

    def __init__(self, buf):
        self.buf = buf
        self.label = self.num_frames = -1
        self._frames = None          # (start, end) of the FeatureList
        end = len(buf)
        for num, wire, s, e in _fields(buf, 0, end):
            if num == 1 and wire == 2:                  # context Features
                for n2, w2, s2, e2 in _fields(buf, s, e):
                    if n2 != 1 or w2 != 2:
                        continue
                    key, value = _map_entry_of(buf, s2, e2)
                    if value is None:
                        continue
                    if key == LABEL_KEY:
                        self.label = _int64_of(buf, *value)
                    elif key == NUM_FRAMES_KEY:
                        self.num_frames = _int64_of(buf, *value)
            elif num == 2 and wire == 2:                # feature_lists
                for n2, w2, s2, e2 in _fields(buf, s, e):
                    if n2 == 1 and w2 == 2:
                        key, value = _map_entry_of(buf, s2, e2)
                        if key == FRAMES_KEY and value is not None:
                            self._frames = value
        if self._frames is None:
            raise ValueError("record has no 'video' frames")
        self._spans: List[Tuple[int, int]] = []
        self._walk = self._walk_frames()

    def _walk_frames(self) -> Iterator[Tuple[int, int]]:
        buf = self.buf
        for num, wire, s, e in _fields(buf, *self._frames):
            if num != 1 or wire != 2:                   # Feature
                continue
            for n2, w2, s2, e2 in _fields(buf, s, e):
                if n2 == 1 and w2 == 2:                 # bytes_list
                    for n3, w3, s3, e3 in _fields(buf, s2, e2):
                        if n3 == 1 and w3 == 2:
                            yield s3, e3

    def frame_spans(self, upto: Optional[int] = None) -> List[Tuple[int, int]]:
        """Byte spans of frames [0, upto), or of every frame."""
        while upto is None or len(self._spans) < upto:
            span = next(self._walk, None)
            if span is None:
                break
            self._spans.append(span)
        return self._spans if upto is None else self._spans[:upto]

    def stored_frames(self) -> int:
        return len(self.frame_spans())

    def size(self) -> int:
        """Frames the sampler sees: ``num_frames`` where set, else the
        count stored (JAX ``pipeline.py:128-130``)."""
        return self.num_frames if self.num_frames > 0 \
            else self.stored_frames()

    def frame(self, i: int) -> memoryview:
        spans = self.frame_spans(i + 1)
        if i >= len(spans):
            raise ValueError(f"frame {i} of a video of {len(spans)} stored "
                             "frames")
        s, e = spans[i]
        return self.buf[s:e]


# ------------------------------------------------------------- the writer

def _process_chunk(args) -> Tuple[str, int]:
    """Decode a shard's videos, trim each to TRIM_SECONDS at its
    container's frame rate (``fps_default`` where it has none), re-encode
    the frames at quality 90 and write the shard (JAX
    ``tfrecords.py:96-118``)."""
    chunk, out_path, fps_default, device = args
    from x3d_tpu_torch.data import video

    def gen():
        for path, label in chunk:
            frames = video.decode_all_frames(path, device=device)
            if frames.shape[0] == 0:
                log.warning("Skipping empty video %s", path)
                continue
            fps = video.video_fps(path) or fps_default
            frames = frames[: int(TRIM_SECONDS * fps)]
            yield frames_to_sequence_example(frames, label, device=device)

    return out_path, write_shard(out_path, gen(), device=device)


def create_tfrecords(video_label_pairs: Sequence[Tuple[str, int]],
                     out_dir: str, prefix: str = "train",
                     videos_per_record: int = 32,
                     num_workers: Optional[int] = None,
                     fps_default: int = 25, device=None) -> List[str]:
    """Write ``(video path, label)`` pairs into GZIP shards of
    ``videos_per_record`` videos, named as the JAX writer names them
    (``<prefix>-00000.tfrecord``, ...), each shard one worker's.

    Videos decode and frames encode on ``device`` (CUDA unless the caller
    asks for the CPU; MJPEG AVIs and JPEG encoding there, other videos on
    the host).  The JAX writer forks a process pool, which CUDA does not
    survive: here the workers are threads on a CUDA device (nvJPEG and the
    host decoders release the interpreter) and spawned processes on the
    CPU.  The shards do not depend on which, nor on how many."""
    from multiprocessing import cpu_count
    from x3d_tpu_torch.utils import resolve_device

    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    chunks = [
        video_label_pairs[i:i + videos_per_record]
        for i in range(0, len(video_label_pairs), videos_per_record)
    ]
    tasks = [
        (chunk, os.path.join(out_dir, f"{prefix}-{i:05d}.tfrecord"),
         fps_default, str(device))
        for i, chunk in enumerate(chunks)
    ]
    num_workers = num_workers or max(1, cpu_count() - 1)
    if num_workers == 1 or len(tasks) <= 1:
        results = [_process_chunk(t) for t in tasks]
    elif device.type == "cuda":
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(num_workers) as pool:
            results = list(pool.map(_process_chunk, tasks))
    else:
        import multiprocessing

        with multiprocessing.get_context("spawn").Pool(num_workers) as pool:
            results = pool.map(_process_chunk, tasks)
    for path, n in results:
        log.info("wrote %s (%d videos)", path, n)
    return [p for p, _ in results]


# ------------------------------------------------------------------- labels

def build_label_map(class_dir: str) -> Dict[str, int]:
    """class-per-folder tree -> {class_name: id} (sorted, 0-based)."""
    classes = sorted(
        d for d in os.listdir(class_dir)
        if os.path.isdir(os.path.join(class_dir, d))
    )
    return {c: i for i, c in enumerate(classes)}


def create_label_file(video_root: str, out_path: str,
                      label_map: Optional[Dict[str, int]] = None,
                      sample_size: Optional[int] = None,
                      extensions: Tuple[str, ...] = (".mp4", ".avi", ".mkv",
                                                     ".webm")) -> int:
    """Walk ``video_root/<class>/<video>`` and emit "path label" lines.

    ``sample_size`` caps videos per class (reference
    kinetics400/create_label.py:42-75).  Returns the line count.
    """
    label_map = label_map or build_label_map(video_root)
    lines = []
    for cls, idx in sorted(label_map.items(), key=lambda kv: kv[1]):
        cdir = os.path.join(video_root, cls)
        if not os.path.isdir(cdir):
            continue
        vids = sorted(
            f for f in os.listdir(cdir)
            if f.lower().endswith(extensions)
        )
        if sample_size:
            vids = vids[:sample_size]
        lines.extend(f"{os.path.join(cdir, v)} {idx}" for v in vids)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
    return len(lines)


def resolve_test_labels(annotations_json: str) -> Dict[str, str]:
    """youtube_id -> label from a Kinetics annotations JSON
    (reference create_tfrecords.py:109-116)."""
    with open(annotations_json) as f:
        ann = json.load(f)
    out = {}
    for vid, meta in ann.items():
        label = meta.get("annotations", {}).get("label")
        if label is not None:
            out[vid] = label
    return out


# ------------------------------------------------- Kinetics-400 metadata

# The reference's ``datasets/kinetics400/`` files, as the JAX package
# ships them: label_map.json (400 classes -> ids, underscores for spaces),
# validate.csv and test.csv (youtube_id and time range a row).
K400_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "datasets", "kinetics400")


def kinetics400_label_map() -> Dict[str, int]:
    """The Kinetics-400 class -> id map (400 entries)."""
    with open(os.path.join(K400_DIR, "label_map.json")) as f:
        return json.load(f)


def kinetics400_split(split: str) -> List[Dict[str, str]]:
    """Rows of the ``validate`` or ``test`` split CSV: dicts with label,
    youtube_id, time_start, time_end, split."""
    import csv

    if split not in ("validate", "test"):
        raise ValueError(f"split must be 'validate' or 'test', got {split!r}")
    with open(os.path.join(K400_DIR, f"{split}.csv")) as f:
        return list(csv.DictReader(f))


def create_test_label_file(video_dir: str, out_path: str,
                           annotations_json: str,
                           label_map: Optional[Dict[str, int]] = None,
                           extensions: Tuple[str, ...] = (".mp4", ".mkv",
                                                          ".avi", ".webm"),
                           ) -> int:
    """Label a FLAT directory of K400 test videos via an annotations JSON
    (reference ``datasets/kinetics400/create_label.py:42-61``): each
    ``<youtube_id>.<ext>`` resolves through the JSON's label string
    (spaces -> underscores) into the label map; unknown ids are warned and
    skipped, as in the reference.  Returns the line count."""
    label_map = label_map or kinetics400_label_map()
    test_labels = resolve_test_labels(annotations_json)
    lines = []
    for fname in sorted(os.listdir(video_dir)):
        if not fname.lower().endswith(extensions):
            continue
        video_key = fname.split(".")[0]
        label_str = test_labels.get(video_key)
        if label_str is None:
            log.warning("%s not found in annotations", fname)
            continue
        idx = label_map.get(label_str.replace(" ", "_"))
        if idx is None:
            log.warning("label %r of %s not in label map", label_str, fname)
            continue
        lines.append(f"{os.path.join(video_dir, fname)} {idx}")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
    return len(lines)


# ---------------------------------------------------------------- inspector

def inspect_tfrecords(cfg, file_pattern: str, out_dir: str,
                      num_samples: int = 4, is_training: bool = True,
                      device=None) -> List[str]:
    """Round-trip samples through the port's reader (uint8 clips, one video
    a batch, on ``device``: CUDA unless the caller asks for the CPU) and
    write each sample's first clip as an animated GIF named by its label
    (JAX ``tfrecords.py:270-292``)."""
    import torch
    from PIL import Image

    from x3d_tpu_torch.data.pipeline import InputReader

    os.makedirs(out_dir, exist_ok=True)
    reader = InputReader(cfg, is_training=is_training, dtype=torch.uint8,
                         device=device)
    written = []
    it = reader(file_pattern, 1)
    try:
        for i, batch in zip(range(num_samples), it):
            clip = batch["video"][0].cpu().numpy()
            label = int(batch["label"][0])
            frames = [Image.fromarray(f) for f in clip]
            path = os.path.join(out_dir, f"sample{i}_label{label}.gif")
            frames[0].save(path, save_all=True, append_images=frames[1:],
                           duration=100, loop=0)
            written.append(path)
    finally:
        it.close()
    return written
