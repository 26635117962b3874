"""TensorFlow checkpoints (tensor bundles) read with numpy, without
TensorFlow.

The counterpart of ``tf.train.load_checkpoint`` and
``tf.train.list_variables`` as the JAX package's import tool uses them
(``x3d_tpu/tools/import_tf_checkpoint.py``).  A checkpoint ``<prefix>``
is two kinds of file:

* ``<prefix>.index``: a LevelDB-style table.  A 48-byte footer holds the
  block handles (varint offset and size) of the metaindex and index blocks
  and the table's magic number.  The index block maps the last key of each
  data block to that block's handle.  A block is a run of prefix-compressed
  entries (varint shared key bytes, varint new key bytes, varint value
  size, the new key bytes, the value), an array of uint32 restart offsets
  where a key is stored whole, and their count; after it on disk come a
  compression byte and the masked CRC-32C of the block and that byte.
  Keys are tensor names in byte order; the key ``""`` holds the
  ``BundleHeaderProto`` (shard count, endianness) and every other key a
  ``BundleEntryProto`` (dtype, shape, shard, offset, size, masked CRC-32C of
  the tensor's bytes).
* ``<prefix>.data-<shard>-of-<shards>``: the tensors' raw little-endian
  bytes, read at an entry's offset and size.

Every block's and every tensor's CRC is checked, with the JPEG library's
host code on the card and Python on the CPU (``data/tfrecords.
crc_function``; about 0.2 s a MiB in Python).  Loaded dtypes: float32,
float64, float16, bfloat16 (returned as float32, exactly) and int32 and
int64.  String tensors (the object graph) are listed but never loaded.
Whatever this reader does not handle -- a compressed block, big-endian
data, a partitioned (sliced) tensor, another dtype -- raises and names the
cause: nothing is skipped quietly.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from x3d_tpu_torch.data.tfrecords import (_fields, _read_varint, crc_function,
                                          masked_crc)

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_SIZE = 48               # two handles padded to 40 bytes, the magic
BLOCK_TRAILER = 5              # compression byte, masked CRC-32C
HEADER_KEY = b""

# tensorflow/core/framework/types.proto
DT_FLOAT, DT_DOUBLE, DT_INT32, DT_STRING, DT_INT64 = 1, 2, 3, 7, 9
DT_BFLOAT16, DT_HALF = 14, 19
_NUMPY = {DT_FLOAT: "<f4", DT_DOUBLE: "<f8", DT_INT32: "<i4",
          DT_INT64: "<i8", DT_HALF: "<f2", DT_BFLOAT16: "<u2"}


class BundleError(ValueError):
    """The checkpoint is malformed or uses what this reader does not
    handle."""


# ------------------------------------------------------------ the table

def _int(buf, start: int, end: int) -> int:
    """A varint field's value, read as a signed int64."""
    v, _ = _read_varint(buf, start, end)
    return v - (1 << 64) if v >= 1 << 63 else v


def _handle(buf, pos: int, end: int) -> Tuple[Tuple[int, int], int]:
    offset, pos = _read_varint(buf, pos, end)
    size, pos = _read_varint(buf, pos, end)
    return (offset, size), pos


def _block(index: bytes, handle: Tuple[int, int], path: str, crc) -> bytes:
    """A block's contents, its compression byte and CRC checked."""
    offset, size = handle
    end = offset + size
    if end + BLOCK_TRAILER > len(index):
        raise BundleError(f"{path}: block at {offset} overruns the file")
    kind = index[end]
    if kind != 0:
        raise BundleError(f"{path}: block at {offset} is compressed (type "
                          f"{kind}); only uncompressed tables are read")
    want, = struct.unpack_from("<I", index, end + 1)
    if masked_crc(crc(index[offset:end + 1])) != want:
        raise BundleError(f"{path}: CRC mismatch in the block at {offset}")
    return index[offset:end]


def _entries(block: bytes, where: str) -> Iterator[Tuple[bytes, bytes]]:
    """(key, value) of each entry of a block, in order."""
    if len(block) < 4:
        raise BundleError(f"{where}: block of {len(block)} bytes")
    n, = struct.unpack_from("<I", block, len(block) - 4)
    limit = len(block) - 4 - 4 * n
    if n == 0 or limit < 0:
        raise BundleError(f"{where}: {n} restart points")
    restarts = set(struct.unpack_from(f"<{n}I", block, limit))
    pos, key = 0, b""
    while pos < limit:
        at = pos
        shared, pos = _read_varint(block, pos, limit)
        fresh, pos = _read_varint(block, pos, limit)
        size, pos = _read_varint(block, pos, limit)
        if shared > len(key) or (at in restarts and shared) \
                or pos + fresh + size > limit:
            raise BundleError(f"{where}: bad entry at byte {at}")
        key = key[:shared] + block[pos:pos + fresh]
        pos += fresh
        yield key, block[pos:pos + size]
        pos += size
        restarts.discard(at)
    if restarts:
        raise BundleError(f"{where}: restart points inside entries")


@dataclass(frozen=True)
class BundleEntry:
    """One tensor's ``BundleEntryProto``."""
    name: str
    dtype: int
    shape: Tuple[int, ...]
    shard_id: int
    offset: int
    size: int
    crc32c: Optional[int]        # masked CRC-32C of the tensor's bytes


def _shape(buf, start: int, end: int, name: str) -> Tuple[int, ...]:
    dims = []
    for num, wire, s, e in _fields(buf, start, end):
        if num == 2 and wire == 2:                     # dim
            size = 0
            for n2, w2, s2, e2 in _fields(buf, s, e):
                if n2 == 1 and w2 == 0:
                    size = _int(buf, s2, e2)
            dims.append(size)
        elif num == 3 and wire == 0 and _int(buf, s, e):
            raise BundleError(f"{name}: unknown rank")
    if any(d < 0 for d in dims):
        raise BundleError(f"{name}: unknown dimension in {dims}")
    return tuple(dims)


def _entry(name: str, value: bytes) -> BundleEntry:
    got = {"dtype": 0, "shape": (), "shard_id": 0, "offset": 0, "size": 0,
           "crc32c": None}
    for num, wire, s, e in _fields(value, 0, len(value)):
        if num == 1 and wire == 0:
            got["dtype"] = _int(value, s, e)
        elif num == 2 and wire == 2:
            got["shape"] = _shape(value, s, e, name)
        elif num in (3, 4, 5) and wire == 0:
            got[{3: "shard_id", 4: "offset", 5: "size"}[num]] = \
                _int(value, s, e)
        elif num == 6 and wire == 5:
            got["crc32c"], = struct.unpack_from("<I", value, s)
        elif num == 7:
            raise BundleError(f"{name}: a partitioned tensor (slices); "
                              "only whole tensors are read")
    return BundleEntry(name=name, **got)


class BundleReader:
    """A TensorFlow tensor bundle ``<prefix>.index`` / ``.data-*``.

    ``crc`` is the CRC-32C function (default: Python's, as
    ``data/tfrecords.crc_function(device)`` gives for the CPU).  The index
    is read, checked and parsed when the reader is made; the data files
    are opened at the first :meth:`get_tensor`.
    """

    def __init__(self, prefix: str, crc=None):
        self.prefix = prefix
        self._crc = crc or crc_function(None)
        path = prefix + ".index"
        with open(path, "rb") as f:
            index = f.read()
        if len(index) < FOOTER_SIZE:
            raise BundleError(f"{path}: {len(index)} bytes, no table footer")
        footer = index[-FOOTER_SIZE:]
        magic, = struct.unpack_from("<Q", footer, FOOTER_SIZE - 8)
        if magic != TABLE_MAGIC:
            raise BundleError(f"{path}: not a table (magic {magic:#x})")
        meta, pos = _handle(footer, 0, FOOTER_SIZE - 8)
        top, _ = _handle(footer, pos, FOOTER_SIZE - 8)
        _block(index, meta, path, self._crc)          # checked, not used
        entries: Dict[str, BundleEntry] = {}
        header = None
        last = None
        self.num_blocks = 0                           # data blocks walked
        for _, value in _entries(_block(index, top, path, self._crc),
                                 f"{path} index block"):
            self.num_blocks += 1
            handle, _ = _handle(value, 0, len(value))
            data = _block(index, handle, path, self._crc)
            for key, v in _entries(data, f"{path} block at {handle[0]}"):
                if last is not None and key <= last:
                    raise BundleError(f"{path}: keys out of order at "
                                      f"{key!r}")
                last = key
                if key == HEADER_KEY:
                    header = v
                else:
                    name = key.decode()
                    entries[name] = _entry(name, v)
        if header is None:
            raise BundleError(f"{path}: no bundle header")
        self.num_shards = 1
        for num, wire, s, e in _fields(header, 0, len(header)):
            if num == 1 and wire == 0:
                self.num_shards = _int(header, s, e)
            elif num == 2 and wire == 0 and _int(header, s, e) != 0:
                raise BundleError(f"{path}: big-endian tensors; only "
                                  "little-endian bundles are read")
        self._entries = entries
        self._files: Dict[int, object] = {}

    def __enter__(self) -> "BundleReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()

    def entry(self, name: str) -> BundleEntry:
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(f"{name!r} is not in {self.prefix}") from None

    def list_variables(self) -> List[Tuple[str, List[int]]]:
        """``[(name, shape)]`` in key order, as
        ``tf.train.list_variables``."""
        return [(n, list(e.shape)) for n, e in self._entries.items()]

    def _shard(self, shard_id: int):
        if shard_id not in self._files:
            if not 0 <= shard_id < self.num_shards:
                raise BundleError(f"{self.prefix}: shard {shard_id} of "
                                  f"{self.num_shards}")
            self._files[shard_id] = open(
                f"{self.prefix}.data-{shard_id:05d}-of-"
                f"{self.num_shards:05d}", "rb")
        return self._files[shard_id]

    def get_tensor(self, name: str) -> np.ndarray:
        """The tensor ``name`` as a numpy array, its CRC checked; bfloat16
        comes back as float32 (exactly)."""
        e = self.entry(name)
        if e.dtype not in _NUMPY:
            what = "a string tensor" if e.dtype == DT_STRING \
                else f"dtype {e.dtype}"
            raise BundleError(f"{name}: {what}; only float32, float64, "
                              "float16, bfloat16, int32 and int64 are read")
        dt = np.dtype(_NUMPY[e.dtype])
        count = int(np.prod(e.shape, dtype=np.int64))
        if e.size != count * dt.itemsize:
            raise BundleError(f"{name}: {e.size} bytes for {e.shape} of "
                              f"{dt}")
        f = self._shard(e.shard_id)
        f.seek(e.offset)
        raw = f.read(e.size)
        if len(raw) != e.size:
            raise BundleError(f"{name}: the data file ends inside it")
        if e.crc32c is None or masked_crc(self._crc(raw)) != e.crc32c:
            raise BundleError(f"{name}: CRC mismatch in the data file")
        arr = np.frombuffer(raw, dt).reshape(e.shape)
        if e.dtype == DT_BFLOAT16:
            return (arr.astype(np.uint32) << 16).view(np.float32)
        return arr.astype(dt.newbyteorder("="))


def load_checkpoint(prefix: str, device=None) -> BundleReader:
    """A reader of the bundle ``prefix`` that checks CRCs the way a
    pipeline on ``device`` does (``tf.train.load_checkpoint``'s
    counterpart)."""
    return BundleReader(prefix, crc=crc_function(device))


def list_variables(prefix: str, device=None) -> List[Tuple[str, List[int]]]:
    """``[(name, shape)]`` of the bundle ``prefix`` in key order, read from
    the index alone (``tf.train.list_variables``'s counterpart)."""
    return load_checkpoint(prefix, device).list_variables()


__all__ = ["BundleEntry", "BundleError", "BundleReader", "list_variables",
           "load_checkpoint"]
