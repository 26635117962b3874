"""Motion-JPEG AVI files read without a video library.

An MJPEG AVI is a RIFF file whose video frames are whole JPEG images:
``RIFF 'AVI '`` holds ``LIST 'hdrl'`` (``avih``; a ``LIST 'strl'`` a
stream with its ``strh`` and ``strf``) and ``LIST 'movi'``, whose
``NNdc`` chunks are stream NN's frames, each padded to an even size.
Writers past 1 GB continue the ``movi`` list in OpenDML ``RIFF 'AVIX'``
parts.  OpenCV writes such files (``VideoWriter_fourcc(*"MJPG")``), and so
do many cameras.  Their frames go to nvJPEG (on the card) or Pillow (on
the CPU) as they are, so the port reads such videos where no video decoder
is installed.

:func:`open_mjpeg` walks the file and keeps each frame's bytes as a
memoryview into it, decoding nothing.  It answers as OpenCV's FFmpeg
backend does for the same file:

* the frame count is the video stream's ``strh.dwLength``
  (``CAP_PROP_FRAME_COUNT``), which may differ from the chunks present;
* the frame rate is ``dwRate / dwScale`` (``CAP_PROP_FPS``);
* a zero-length chunk (a dropped frame) is counted in ``dwLength`` but
  gives no frame: frame *i* is the *i*-th chunk that holds data, as
  ``VideoCapture.read`` returns them.

Camera MJPEG (``AVI1``) often leaves out the Huffman tables, which JPEG
decoders then take from ITU T.81 Annex K.3; :meth:`MjpegAvi.jpeg` inserts
those tables where a frame has none, since nvJPEG does not assume them.

Anything else is "not MJPEG" and :func:`open_mjpeg` returns None: another
codec, no video stream, a malformed header, or interlaced frames (two
fields a chunk, told by the ``AVI1`` marker or by frames half the
stream's height).  The caller then decodes the file with a video library.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from x3d_tpu_torch.ops.jpeg import image_size

MJPEG_CODECS = (b"MJPG",)       # strh handler or strf biCompression

# ITU T.81 Annex K.3: the standard Huffman tables (class/id byte, the
# 16 code-length counts, the symbols), in one DHT segment
_STD_TABLES = (
    (0x00, "00010501010101010100000000000000",
     "000102030405060708090a0b"),
    (0x10, "0002010303020403050504040000017d",
     "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
     "2433627282090a161718191a25262728292a3435363738393a43444546474849"
     "4a535455565758595a636465666768696a737475767778797a83848586878889"
     "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
     "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
     "f9fa"),
    (0x01, "00030101010101010101010000000000",
     "000102030405060708090a0b"),
    (0x11, "00020102040403040705040400010277",
     "000102031104052131061241510761711322328108144291a1b1c109233352f0"
     "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
     "494a535455565758595a636465666768696a737475767778797a828384858687"
     "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
     "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
     "f9fa"),
)


def _std_dht() -> bytes:
    body = b""
    for tc_th, bits, vals in _STD_TABLES:
        counts = bytes.fromhex(bits)
        symbols = bytes.fromhex(vals)
        if sum(counts) != len(symbols):
            raise AssertionError("Annex K table miscounted")
        body += bytes([tc_th]) + counts + symbols
    return b"\xff\xc4" + struct.pack(">H", len(body) + 2) + body


STD_DHT = _std_dht()


@dataclass
class MjpegAvi:
    """The video stream of an MJPEG AVI: ``count`` (as OpenCV counts it),
    ``fps`` (None where the header gives none), ``width``, ``height``
    and the frames that hold data (``len(self)``), as memoryviews into the
    file's bytes (``data``)."""
    path: str
    data: bytes
    count: int
    fps: Optional[float]
    width: int
    height: int
    spans: List[Tuple[int, int]] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.spans)

    def frame(self, i: int) -> memoryview:
        """Frame ``i``'s chunk, as it is in the file."""
        s, e = self.spans[i]
        return memoryview(self.data)[s:e]

    def jpeg(self, i: int):
        """Frame ``i`` as a JPEG that any decoder takes: the chunk, with the
        standard Huffman tables inserted where it has none."""
        return with_huffman_tables(self.frame(i))


def with_huffman_tables(buf):
    """``buf`` (a JPEG) unchanged where it has a DHT segment before its
    scan, else with ITU T.81 Annex K.3's tables inserted before the scan."""
    pos, end = 2, len(buf)
    if bytes(buf[:2]) != b"\xff\xd8":
        raise ValueError("not a JPEG (no start-of-image marker)")
    while pos + 4 <= end:
        if buf[pos] != 0xFF:
            raise ValueError("malformed JPEG header")
        marker = buf[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if 0xD0 <= marker <= 0xD8 or marker == 0x01:
            pos += 2
            continue
        if marker == 0xC4:
            return buf
        if marker == 0xDA:
            return b"".join((bytes(buf[:pos]), STD_DHT, bytes(buf[pos:])))
        pos += 2 + (buf[pos + 2] << 8 | buf[pos + 3])
    raise ValueError("malformed JPEG header (no scan)")


def _interlaced(buf) -> bool:
    """True where a frame's ``AVI1`` APP0 marks it as fields."""
    pos, end = 2, min(len(buf), 4096)
    while pos + 4 <= end and buf[pos] == 0xFF:
        marker = buf[pos + 1]
        if marker == 0xDA:
            break
        n = buf[pos + 2] << 8 | buf[pos + 3]
        if marker == 0xE0 and bytes(buf[pos + 4:pos + 8]) == b"AVI1":
            return pos + 8 < end and buf[pos + 8] != 0
        pos += 2 + n
    return False


def _chunks(data: bytes, pos: int, end: int):
    """(fourcc, start, size) of the chunks in data[pos:end]; stops at a
    chunk that runs past ``end``."""
    while pos + 8 <= end:
        cid = data[pos:pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        if pos + 8 + size > end:
            return
        yield cid, pos + 8, size
        pos += 8 + size + (size & 1)


def _header(data: bytes, start: int, size: int):
    """(count, fps, width, height, stream number) of the first video
    stream in ``LIST 'hdrl'``; None where it is not MJPEG."""
    stream = 0
    for cid, s, n in _chunks(data, start + 4, start + size):
        if cid != b"LIST" or data[s:s + 4] != b"strl":
            continue
        strh = strf = None
        for cid2, s2, n2 in _chunks(data, s + 4, s + n):
            if cid2 == b"strh" and n2 >= 36:
                strh = (s2, n2)
            elif cid2 == b"strf":
                strf = (s2, n2)
        if strh is not None and data[strh[0]:strh[0] + 4] == b"vids":
            s2 = strh[0]
            handler = data[s2 + 4:s2 + 8].upper()
            scale, rate = struct.unpack_from("<II", data, s2 + 20)
            (length,) = struct.unpack_from("<I", data, s2 + 32)
            width = height = 0
            compression = b""
            if strf is not None and strf[1] >= 20:
                _, width, height = struct.unpack_from("<Iii", data, strf[0])
                compression = data[strf[0] + 16:strf[0] + 20].upper()
            if handler not in MJPEG_CODECS \
                    and compression not in MJPEG_CODECS:
                return None
            fps = rate / scale if scale and rate else None
            return length, fps, width, abs(height), stream
        stream += 1
    return None


def read_header(path: str) -> Optional[bytes]:
    """The whole file where it starts as a RIFF AVI, else None (reading 12
    bytes)."""
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"AVI ":
            return None
        return head + f.read()


def parse(path: str, data: bytes) -> Optional[MjpegAvi]:
    """Walk an AVI file's bytes (see the module docstring); None where it
    is not an MJPEG AVI."""
    end = len(data)
    (riff_size,) = struct.unpack_from("<I", data, 4)
    first_end = min(end, 8 + riff_size)
    header = None
    movi: List[Tuple[int, int]] = []
    for cid, s, n in _chunks(data, 12, first_end):
        if cid != b"LIST":
            continue
        kind = data[s:s + 4]
        if kind == b"hdrl" and header is None:
            header = _header(data, s, n)
            if header is None:
                return None
        elif kind == b"movi":
            movi.append((s + 4, s + n))
    if header is None:
        return None
    # OpenDML continuations: RIFF 'AVIX' parts, each with its own movi list
    pos = 8 + riff_size + (riff_size & 1)
    for cid, s, n in _chunks(data, pos, end):
        if cid == b"RIFF" and data[s:s + 4] == b"AVIX":
            for cid2, s2, n2 in _chunks(data, s + 4, s + n):
                if cid2 == b"LIST" and data[s2:s2 + 4] == b"movi":
                    movi.append((s2 + 4, s2 + n2))
    count, fps, width, height, stream = header
    want = b"%02ddc" % stream
    spans: List[Tuple[int, int]] = []

    def walk(start, stop):
        for cid, s, n in _chunks(data, start, stop):
            if cid == want:
                if n:
                    spans.append((s, s + n))
            elif cid == b"LIST" and data[s:s + 4] == b"rec ":
                walk(s + 4, s + n)

    for start, stop in movi:
        walk(start, stop)
    avi = MjpegAvi(path, data, count, fps, width, height, spans)
    if spans:
        first = avi.frame(0)
        try:
            h, w = image_size(first)
        except ValueError:
            return None
        if _interlaced(first) or (height and h != height) \
                or (width and w != width):
            return None
    return avi


def open_mjpeg(path: str) -> Optional[MjpegAvi]:
    """The MJPEG AVI at ``path``, or None where the file is something else
    (see the module docstring)."""
    data = read_header(path)
    return None if data is None else parse(path, data)
