"""JPEG decode and encode for the input pipeline: nvJPEG on the card.

:func:`decode_batch` decodes a batch's sampled frames (RGB interleaved)
into one uint8 arena, each frame at an offset: on a CUDA device through
nvJPEG's batched decoder (``kernels/csrc/jpeg.cu``) on PyTorch's current
stream, the bitstreams staged in pinned host memory; on the CPU through
Pillow, its plain version (libjpeg's accurate integer IDCT, which
TensorFlow's ``decode_jpeg`` gives with ``dct_method="INTEGER_ACCURATE"``).
:func:`encode` writes quality-90 4:2:0 JPEGs for the shard writer the same
way.  On a CUDA device no Pillow code runs: the codec runs or raises.

The backend is chosen explicitly, the first of :data:`BACKENDS` that
``nvjpegCreateEx`` accepts: the hardware decoder, then Huffman decoding
on the GPU, then nvJPEG's default; the device's codec
(:func:`device_codec`) names the one that runs.  :func:`image_size` reads
a frame's size from its header in Python, so a pipeline plans its crops
before anything is decoded.  :func:`crc32c` is the library's host CRC-32C
for TFRecord framing, outside Python's interpreter lock.
"""

from __future__ import annotations

import ctypes
import io
import threading
from typing import List, Sequence, Tuple

import numpy as np
import torch

from x3d_tpu_torch import kernels
from x3d_tpu_torch.kernels import _build

_SIGNATURES = {
    "x3d_jpeg_create": [ctypes.c_int, ctypes.c_void_p],
    "x3d_jpeg_destroy": [ctypes.c_void_p],
    "x3d_jpeg_state_create": [ctypes.c_void_p, ctypes.c_void_p],
    "x3d_jpeg_state_destroy": [ctypes.c_void_p],
    "x3d_jpeg_decode": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_void_p] * 7,
    "x3d_jpeg_encode": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_ulonglong, ctypes.c_void_p, ctypes.c_void_p],
    "x3d_crc32c": [ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_void_p],
}

# nvjpegBackend_t values, in the order they are tried: the H100's decode
# engines, then Huffman decoding on the GPU (which keeps the host's cores
# for inflating shards), then nvJPEG's default (Huffman on the host)
BACKENDS = (("hardware", 3), ("gpu_hybrid", 2), ("default", 0))
_STATUS = {1: "NOT_INITIALIZED", 2: "INVALID_PARAMETER", 3: "BAD_JPEG",
           4: "JPEG_NOT_SUPPORTED", 5: "ALLOCATOR_FAILURE",
           6: "EXECUTION_FAILED", 7: "ARCH_MISMATCH", 8: "INTERNAL_ERROR",
           9: "IMPLEMENTATION_NOT_SUPPORTED", 2001: "size differs from plan",
           2002: "not a 1- or 3-component JPEG", 2003: "buffer too small"}
ARENA_ALIGN = 256          # bytes between the starts of decoded frames

_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD,
        0xCE, 0xCF}


def _lib():
    return _build.load("jpeg.cu", _SIGNATURES)


def status_name(rc: int) -> str:
    if rc > 1000 and rc < 2000:
        return f"CUDA error {rc - 1000}"
    return _STATUS.get(rc, f"status {rc}")


def image_size(data) -> Tuple[int, int]:
    """(height, width) from a JPEG's start-of-frame header; raises
    ValueError where the bytes are not a JPEG."""
    buf = bytes(data[:2])
    if buf != b"\xff\xd8":
        raise ValueError("not a JPEG (no start-of-image marker)")
    mv = memoryview(data)
    pos, end = 2, len(mv)
    while pos + 4 <= end:
        if mv[pos] != 0xFF:
            raise ValueError("malformed JPEG header")
        marker = mv[pos + 1]
        if marker == 0xFF:                      # fill byte
            pos += 1
            continue
        if 0xD0 <= marker <= 0xD9 or marker == 0x01:
            pos += 2
            continue
        seg = mv[pos + 2] << 8 | mv[pos + 3]
        if marker in _SOF:
            if pos + 9 > end:
                break
            return (mv[pos + 5] << 8 | mv[pos + 6],
                    mv[pos + 7] << 8 | mv[pos + 8])
        pos += 2 + seg
    raise ValueError("malformed JPEG header (no start-of-frame)")


class Codec:
    """An nvJPEG handle on a device, used under a lock; a batched-decode
    state for each stream that decodes (nvJPEG orders a state's work only
    within one stream, and two readers decode on streams of their own);
    and the pinned staging buffers its decodes read the bitstreams from
    (two, each reused only after the decode that read it has finished).
    It takes the first of ``backends`` (names of :data:`BACKENDS`) that
    nvJPEG accepts; ``refused`` lists the others tried."""

    def __init__(self, device: torch.device, backends=None):
        lib = _lib()
        self.device = device
        self.lock = threading.Lock()
        handle = ctypes.c_void_p()
        tried = []
        order = [(n, c) for n, c in BACKENDS
                 if backends is None or n in backends]
        with torch.cuda.device(device):
            for name, code in order:
                rc = lib.x3d_jpeg_create(code, ctypes.byref(handle))
                if rc == 0:
                    self.backend = name
                    break
                tried.append(f"{name}: {status_name(rc)}")
            else:
                raise RuntimeError(f"nvJPEG: no backend: {tried}")
        self.refused = tried
        self.handle = handle
        self.states = {}             # stream handle -> decode state
        self.staging = [None, None]
        self.events = [None, None]
        self.turn = 0

    def close(self) -> None:
        """Destroy the nvJPEG handle and its states (after the decodes have
        finished)."""
        torch.cuda.synchronize(self.device)
        lib = _lib()
        for state in self.states.values():
            lib.x3d_jpeg_state_destroy(state)
        self.states.clear()
        lib.x3d_jpeg_destroy(self.handle)
        self.handle = None

    def state(self, stream: int) -> ctypes.c_void_p:
        """The decode state of ``stream`` (a raw handle), made on first use;
        called under the lock."""
        state = self.states.get(stream)
        if state is None:
            state = ctypes.c_void_p()
            rc = _lib().x3d_jpeg_state_create(self.handle,
                                              ctypes.byref(state))
            if rc != 0:
                raise RuntimeError(f"nvJPEG: no decode state: "
                                   f"{status_name(rc)}")
            self.states[stream] = state
        return state

    def stage(self, blobs: Sequence):
        """Copy the bitstreams into the next pinned buffer; returns their
        host addresses and lengths (uint64) and the event to record once
        the decode reading them is enqueued."""
        lengths = np.array([len(b) for b in blobs], np.uint64)
        starts = np.zeros(len(blobs) + 1, np.int64)
        np.cumsum(lengths.astype(np.int64), out=starts[1:])
        k = self.turn
        self.turn ^= 1
        if self.events[k] is not None:
            self.events[k].synchronize()
        buf = self.staging[k]
        if buf is None or buf.numel() < starts[-1]:
            buf = torch.empty(int(starts[-1] * 5 // 4) + 4096,
                              dtype=torch.uint8, pin_memory=True)
            self.staging[k] = buf
        host = buf.numpy()
        for b, s, n in zip(blobs, starts[:-1], lengths):
            host[s:s + int(n)] = np.frombuffer(b, np.uint8)
        event = torch.cuda.Event()
        self.events[k] = event
        return (buf.data_ptr() + starts[:-1]).astype(np.uint64), lengths, \
            event


_codecs = {}
_codecs_lock = threading.Lock()


def device_codec(device="cuda") -> Codec:
    """The device's codec: on the first backend of :data:`BACKENDS` that
    nvJPEG accepts (``.backend`` names it, ``.refused`` the others)."""
    device = torch.device(device)
    device = torch.device("cuda", device.index if device.index is not None
                          else torch.cuda.current_device())
    with _codecs_lock:
        if device not in _codecs:
            _codecs[device] = Codec(device)
        return _codecs[device]


def arena_layout(sizes: Sequence[Tuple[int, int]]) -> Tuple[np.ndarray, int]:
    """Offsets of RGB frames of (height, width) ``sizes`` in one arena, each
    at a multiple of ARENA_ALIGN, and the arena's size in bytes."""
    nbytes = np.array([h * w * 3 for h, w in sizes], np.int64)
    padded = (nbytes + ARENA_ALIGN - 1) // ARENA_ALIGN * ARENA_ALIGN
    offsets = np.zeros(len(sizes), np.int64)
    if len(sizes) > 1:
        np.cumsum(padded[:-1], out=offsets[1:])
    return offsets, int(padded.sum()) if len(sizes) else 0


def decode_batch_reference(blobs: Sequence, sizes: Sequence[Tuple[int, int]]
                           ) -> Tuple[torch.Tensor, np.ndarray]:
    """Plain version of :func:`decode_batch`: Pillow on the CPU."""
    from PIL import Image

    offsets, total = arena_layout(sizes)
    arena = torch.empty(total, dtype=torch.uint8)
    host = arena.numpy()
    for i, (b, (h, w), off) in enumerate(zip(blobs, sizes, offsets)):
        try:
            img = np.asarray(Image.open(io.BytesIO(bytes(b))).convert("RGB"))
        except (OSError, ValueError) as e:
            raise DecodeError(i, f"JPEG decode failed: {e}") from e
        if img.shape != (h, w, 3):
            raise DecodeError(i, f"decoded {img.shape[:2]}, planned "
                                 f"{(h, w)}")
        host[off:off + h * w * 3] = img.reshape(-1)
    return arena, offsets


class DecodeError(ValueError):
    """A bitstream of a batch failed; ``index`` is its position."""

    def __init__(self, index: int, msg: str):
        super().__init__(msg)
        self.index = index


def decode_batch(blobs: Sequence, sizes: Sequence[Tuple[int, int]],
                 device=None, codec: Codec = None
                 ) -> Tuple[torch.Tensor, np.ndarray]:
    """Decode JPEG bitstreams of planned (height, width) ``sizes`` into one
    flat uint8 arena of RGB interleaved frames on ``device``; returns the
    arena and each frame's byte offset in it.

    On a CUDA device nvJPEG decodes on the current stream or this raises
    :class:`DecodeError` (its ``index`` names the bitstream at fault, -1
    for the batch), through ``codec`` (default: the device's, on the first
    backend of :data:`BACKENDS` that nvJPEG accepts); on the CPU Pillow
    decodes, and a bitstream it cannot decode raises :class:`DecodeError`
    with its index.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cpu":
        try:
            return decode_batch_reference(blobs, sizes)
        except DecodeError:
            raise
        except Exception as e:
            raise DecodeError(-1, f"JPEG decode failed: {e}") from e
    codec = codec or device_codec(device)
    lib = _lib()
    offsets, total = arena_layout(sizes)
    arena = torch.empty(max(total, 1), dtype=torch.uint8, device=device)
    hw = np.array(sizes, np.int32).reshape(-1, 2)
    heights = np.ascontiguousarray(hw[:, 0])
    widths = np.ascontiguousarray(hw[:, 1])
    outputs = (arena.data_ptr() + offsets).astype(np.uint64)
    bad = ctypes.c_int(-1)
    stream = kernels.stream_handle(arena)
    with codec.lock:
        ptrs, lengths, event = codec.stage(blobs)
        rc = lib.x3d_jpeg_decode(
            codec.handle, codec.state(stream), len(blobs), ptrs.ctypes.data,
            lengths.ctypes.data, outputs.ctypes.data, heights.ctypes.data,
            widths.ctypes.data, ctypes.byref(bad), stream)
        event.record()
    if rc != 0:
        raise DecodeError(bad.value, f"nvJPEG decode failed: "
                                     f"{status_name(rc)}")
    decode_batch.launches += 1
    return arena, offsets


decode_batch.launches = 0


def encode_reference(frames: np.ndarray, quality: int) -> List[bytes]:
    """Plain version of :func:`encode`: Pillow (libjpeg, 4:2:0), with the
    300-dpi JFIF density that ``tf.io.encode_jpeg`` writes, so that the
    bytes are the JAX writer's."""
    from PIL import Image

    out = []
    for f in frames:
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(f)).save(
            buf, format="JPEG", quality=quality, dpi=(300, 300))
        out.append(buf.getvalue())
    return out


def encode(frames, quality: int = 90, device=None) -> List[bytes]:
    """(N, H, W, 3) uint8 frames (numpy or a tensor) -> N baseline JPEGs
    (4:2:0).  On ``device``: CUDA (nvJPEG) unless the caller asks for the
    CPU (Pillow)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cpu":
        if isinstance(frames, torch.Tensor):
            frames = frames.cpu().numpy()
        return encode_reference(np.asarray(frames, np.uint8), quality)
    x = torch.as_tensor(frames).to(device=device, dtype=torch.uint8)
    x = x.contiguous()
    kernels.check_cuda(x)
    n, h, w, c = x.shape
    if c != 3:
        raise ValueError(f"expected RGB frames, got {tuple(x.shape)}")
    codec = device_codec(x.device)
    lib = _lib()
    cap = h * w * 3 + 65536
    dst = np.empty(cap, np.uint8)
    length = ctypes.c_ulonglong()
    out = []
    with codec.lock:
        for i in range(n):
            rc = lib.x3d_jpeg_encode(
                codec.handle, x[i].data_ptr(), h, w, quality, dst.ctypes.data,
                cap, ctypes.byref(length), kernels.stream_handle(x))
            if rc != 0:
                raise RuntimeError(f"nvJPEG encode failed: "
                                   f"{status_name(rc)}")
            out.append(dst[:length.value].tobytes())
    encode.launches += n
    return out


encode.launches = 0


def crc32c(data) -> int:
    """CRC-32C of host bytes, in the library's host code (needs the CUDA
    toolkit to build)."""
    lib = _lib()
    mv = memoryview(data)
    if not mv.contiguous:
        mv = memoryview(bytes(mv))
    n = mv.nbytes
    if n == 0:
        return 0
    arr = np.frombuffer(mv, np.uint8)
    out = ctypes.c_uint()
    lib.x3d_crc32c(arr.ctypes.data, n, ctypes.byref(out))
    return out.value
