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
CUDA device, Pillow for frames on the CPU.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

JPEG_QUALITY = 90          # the JAX writer's (tfrecords.py:29)
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
