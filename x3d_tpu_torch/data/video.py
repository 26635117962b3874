"""Raw-video decoding: Motion-JPEG AVIs first, then the host's backends.

The counterpart of the JAX package's ``x3d_tpu/data/video.py``, with one
addition.  A Motion-JPEG AVI (``data/avi.py``) is read without a video
library on every device: its sampled frames are JPEGs, decoded by nvJPEG
on the card and by Pillow on the CPU.  Every other file goes through the
first backend that imports, in the JAX module's order: decord, OpenCV
(libavcodec), imageio; with none, decoding raises ImportError naming them.
The card machine has none of the three, so there MJPEG AVIs are what the
port can decode.

As in the reference (``dataloader.py:53-61``), an undecodable video gives
zeros of :data:`_FALLBACK_SHAPE` and a warning instead of stopping the
input pipeline; :class:`Sampled` says where that happened, and the reader
counts it.

OpenCV decodes sequentially and skips the colour conversion of unsampled
frames (``grab``); where the container's frame count is more than the
frames that decode, the sampled decode falls back to a full decode and
samples again over the frames it got (JAX ``video.py:190-197``).  An MJPEG
AVI answers as OpenCV does: its count is ``strh.dwLength``, and its
frames are the chunks that hold data, so the same fallback applies.
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Optional

import numpy as np
import torch

from x3d_tpu_torch.data import avi
from x3d_tpu_torch.ops import jpeg
from x3d_tpu_torch.utils import resolve_device

log = logging.getLogger(__name__)

_FALLBACK_SHAPE = (100, 240, 144, 3)  # reference dataloader.py:61


class Sampled(NamedTuple):
    """A video's sampled frames ((len(indices), H, W, 3) uint8: numpy on
    the CPU, a tensor on a CUDA device), the frame indices they are, and
    whether they are the zeros that stand in for an undecodable video."""
    frames: object
    indices: np.ndarray
    substituted: bool


def available_backend() -> Optional[str]:
    """The first host backend that imports: decord, OpenCV or imageio."""
    try:
        import decord  # noqa: F401

        return "decord"
    except ImportError:
        pass
    try:
        import cv2  # noqa: F401

        return "opencv"
    except ImportError:
        pass
    try:
        import imageio.v3 as iio  # noqa: F401

        return "imageio"
    except ImportError:
        pass
    return None


def _no_backend() -> ImportError:
    return ImportError(
        "No video decode backend available: install decord, "
        "opencv-python, or imageio[pyav]/imageio-ffmpeg, or use the "
        "TFRecord pipeline.  Motion-JPEG AVIs are read without them.")


def open_mjpeg(path: str) -> Optional[avi.MjpegAvi]:
    """The MJPEG AVI at ``path``, None where it is another file or cannot
    be read (the host backends then say why)."""
    try:
        return avi.open_mjpeg(path)
    except OSError:
        return None


def video_fps(path: str) -> Optional[float]:
    """Container frame rate: an MJPEG AVI's header, else the first
    metadata-capable backend's (decord, OpenCV); None where none says.

    The JAX writer trims each video to its first 10 seconds at this rate
    (``tfrecords.py:112-118``)."""
    mjpeg = open_mjpeg(path)
    if mjpeg is not None:
        return mjpeg.fps
    backend = available_backend()
    try:
        if backend == "decord":
            import decord

            return float(decord.VideoReader(path, ctx=decord.cpu(0))
                         .get_avg_fps())
        if backend == "opencv":
            import cv2

            cap = cv2.VideoCapture(path)
            try:
                if cap.isOpened():
                    fps = cap.get(cv2.CAP_PROP_FPS)
                    return float(fps) if fps and fps > 0 else None
            finally:
                cap.release()
    except Exception:  # pragma: no cover - corrupt files
        pass
    return None


def _opencv_decode(path: str, keep: Optional[set] = None) -> dict:
    """Sequentially decode ``path`` with cv2, keeping frames in ``keep``
    (all frames when None).  Returns {index: (H, W, 3) uint8 RGB}.

    Sequential grab()+retrieve() rather than CAP_PROP_POS_FRAMES seeks:
    frame-accurate seeking is codec-dependent (inter-coded frames land on
    the previous keyframe), while grab() skips only the color conversion,
    which is the cheap, always-exact way to subsample.
    """
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise RuntimeError(f"OpenCV cannot open {path}")
    frames = {}
    pos = 0
    last = max(keep) if keep else None
    try:
        while True:
            if keep is not None and pos > last:
                break
            if keep is None or pos in keep:
                ok, frame = cap.read()
                if not ok:
                    break
                frames[pos] = np.ascontiguousarray(frame[..., ::-1])
            elif not cap.grab():
                break
            pos += 1
    finally:
        cap.release()
    if not frames:
        raise RuntimeError(f"OpenCV decoded no frames from {path}")
    return frames


def decode_jpegs(mjpeg: avi.MjpegAvi, indices, device) -> object:
    """Frames ``indices`` of an MJPEG AVI, (N, H, W, 3) uint8: nvJPEG on a
    CUDA device (a tensor there), Pillow on the CPU (numpy)."""
    blobs = [mjpeg.jpeg(int(i)) for i in indices]
    h, w = jpeg.image_size(blobs[0])
    arena, offsets = jpeg.decode_batch(blobs, [(h, w)] * len(blobs), device)
    n = h * w * 3
    frames = torch.stack([arena[o:o + n] for o in offsets.tolist()]) \
        .view(len(blobs), h, w, 3)
    return frames.numpy() if arena.device.type == "cpu" else frames


def _zeros(n: int, device):
    frames = np.zeros((n,) + _FALLBACK_SHAPE[1:], np.uint8)
    return frames if device.type == "cpu" else torch.from_numpy(frames).to(
        device)


def _on(frames: np.ndarray, device):
    return frames if device.type == "cpu" else torch.from_numpy(
        np.ascontiguousarray(frames)).to(device)


def _host_decode_all(path: str) -> np.ndarray:
    """Every frame by the first host backend; raises on failure."""
    backend = available_backend()
    if backend == "decord":
        import decord

        vr = decord.VideoReader(path, ctx=decord.cpu(0))
        return vr.get_batch(range(len(vr))).asnumpy()
    if backend == "opencv":
        frames = _opencv_decode(path)
        return np.stack([frames[i] for i in range(len(frames))])
    if backend == "imageio":
        import imageio.v3 as iio

        frames = np.asarray(iio.imread(path, plugin=None))
        # normalise what the plugin returned to (N, H, W, 3) uint8:
        # pillow decodes GIFs as RGBA / palette, single images as rank 3
        if frames.ndim == 3:
            frames = frames[None]
        if frames.shape[-1] > 3:
            frames = frames[..., :3]
        elif frames.shape[-1] < 3:
            frames = np.repeat(frames[..., :1], 3, axis=-1)
        return np.ascontiguousarray(frames, dtype=np.uint8)
    raise _no_backend()


def _decode_all(path: str, device) -> tuple:
    """(every frame, substituted): zeros of _FALLBACK_SHAPE where the video
    does not decode."""
    mjpeg = open_mjpeg(path)
    try:
        if mjpeg is not None:
            if not len(mjpeg):
                raise RuntimeError(f"no frame holds data in {path}")
            return decode_jpegs(mjpeg, range(len(mjpeg)), device), False
        return _on(_host_decode_all(path), device), False
    except ImportError:
        raise
    except Exception as e:
        log.warning("Failed to decode video %s (%s); substituting zeros.",
                    path, e)
        return _zeros(_FALLBACK_SHAPE[0], device), True


def decode_all_frames(path: str, device=None):
    """(N, H, W, 3) uint8 for every frame, zeros on failure: numpy on the
    CPU, a tensor on a CUDA device (the default unless the caller asks for
    the CPU).  An MJPEG AVI's frames are decoded there (nvJPEG or Pillow),
    other files' by the host backend and moved there."""
    return _decode_all(path, resolve_device(device))[0]


def sample_mjpeg(mjpeg: avi.MjpegAvi, sampler, rng=None):
    """The sampler's frame indices into an MJPEG AVI's frames, as
    :func:`decode_frames_sampled` draws them through OpenCV: over its
    count, or where that count is 0 or more than the frames that hold
    data, over those frames; None where none holds data."""
    if mjpeg.count > 0:
        idx = np.asarray(sampler.indices(mjpeg.count, rng))
        if int(idx.max()) < len(mjpeg):
            return idx
        log.warning("frame count %d for %s not fully decodable; "
                    "sampling the %d frames that are.", mjpeg.count,
                    mjpeg.path, len(mjpeg))
    if not len(mjpeg):
        return None
    return np.asarray(sampler.indices(len(mjpeg), rng))


def host_frames_sampled(path: str, sampler, rng=None) -> Sampled:
    """JAX ``decode_frames_sampled`` on the host backends, frames on the
    CPU."""
    def zeros(e):
        log.warning("%s failed on %s (%s); substituting zeros.", backend,
                    path, e)
        idx = np.asarray(sampler.indices(100, rng))
        return Sampled(np.zeros((idx.size,) + _FALLBACK_SHAPE[1:], np.uint8),
                       idx, True)

    backend = available_backend()
    if backend == "decord":
        try:
            import decord

            vr = decord.VideoReader(path, ctx=decord.cpu(0))
            idx = np.asarray(sampler.indices(len(vr), rng))
            return Sampled(vr.get_batch(idx.tolist()).asnumpy(), idx, False)
        except Exception as e:
            return zeros(e)
    if backend == "opencv":
        try:
            import cv2

            cap = cv2.VideoCapture(path)
            n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) if cap.isOpened() \
                else 0
            cap.release()
            if n > 0:
                idx = np.asarray(sampler.indices(n, rng))
                frames = _opencv_decode(path, keep=set(int(i)
                                                       for i in idx.ravel()))
                if all(int(i) in frames for i in idx.ravel()):
                    return Sampled(np.stack([frames[int(i)]
                                             for i in idx.ravel()]),
                                   idx, False)
                # container metadata overcounted (rare; e.g. truncated
                # moov atom) -- fall through to the exact full decode
                log.warning(
                    "OpenCV frame count %d for %s not fully decodable; "
                    "falling back to full decode.", n, path)
        except Exception as e:
            return zeros(e)
    try:
        video, substituted = _host_decode_all(path), False
    except ImportError:
        raise
    except Exception as e:
        log.warning("Failed to decode video %s (%s); substituting zeros.",
                    path, e)
        video, substituted = np.zeros(_FALLBACK_SHAPE, np.uint8), True
    idx = np.asarray(sampler.indices(video.shape[0], rng))
    return Sampled(video[idx], idx, substituted)


def decode_frames_sampled(path: str, sampler, rng=None,
                          device=None) -> Sampled:
    """Decode a video's frames at the sampler's indices
    (``sampler.indices(size, rng)``; ``rng`` for a training sampler's
    draw).

    An MJPEG AVI decodes only the sampled frames' JPEGs, on ``device``
    (CUDA unless the caller asks for the CPU).  Otherwise, as the JAX
    module: decord seeks to them; OpenCV decodes sequentially, skipping
    the colour conversion of unsampled frames; other backends decode every
    frame and gather; the frames are then moved to ``device``."""
    device = resolve_device(device)
    mjpeg = open_mjpeg(path)
    if mjpeg is None:
        got = host_frames_sampled(path, sampler, rng)
        return got._replace(frames=_on(got.frames, device))
    try:
        idx = sample_mjpeg(mjpeg, sampler, rng)
        if idx is None:
            raise RuntimeError(f"no frame holds data in {path}")
        return Sampled(decode_jpegs(mjpeg, idx.ravel(), device), idx, False)
    except Exception as e:
        log.warning("Failed to decode video %s (%s); substituting zeros.",
                    path, e)
        idx = np.asarray(sampler.indices(100, rng))
        return Sampled(_zeros(idx.size, device), idx, True)
