"""The clip kernel: decoded frames -> the model's normalised input batch.

Every clip frame of a batch (N, T, S, S, 3) is one bilinear map from one
decoded frame, which lies in a flat uint8 arena (RGB interleaved, rows
packed): a row of :data:`MAP_DTYPE` in a table of M = N * T rows gives the
frame's byte offset in the arena and its row pitch, a window of the frame
(``win_y, win_x, win_h, win_w``), an output offset (``off_y, off_x``), a
scale in y and x and a flip bit.  Output pixel (y, x) samples the window
at ``in = (float(y + off) + 0.5) * scale - 0.5`` in each axis, taps
clamped to the window (as TensorFlow clamps them to the frame), with tf.image.resize's bilinear arithmetic in
float32 and its order of lerps; the flip mirrors x first.  The value is
truncated to uint8 as ``tf.cast`` does and normalised as
:func:`x3d_tpu_torch.utils.normalize` does, in float32, or left as uint8.

Training's fast crop (``x3d_tpu/data/pipeline.py:142-201``) is a window
of the frame resized to (S, S): off 0, scale window/S.  Eval's short-side
resize and uniform crop (``x3d_tpu/data/transforms.py:108-192``) is the
whole frame as the window, the crop's offset as ``off`` and scale
frame/resized side; its crops read one decoded frame in place.

:func:`clip_prep` wraps the hand-written CUDA kernel
(``kernels/csrc/clip_prep.cu``, compiled without contracted multiply-adds
so that it rounds as this plain version does);
:func:`clip_prep_reference` is its plain PyTorch version.  A CPU arena
takes the plain version; a CUDA arena launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from x3d_tpu_torch import kernels
from x3d_tpu_torch.kernels import _build

MAP_DTYPE = np.dtype([
    ("src", np.int64), ("pitch", np.int32), ("win_y", np.int32),
    ("win_x", np.int32), ("win_h", np.int32), ("win_w", np.int32),
    ("off_y", np.int32), ("off_x", np.int32), ("flip", np.int32),
    ("scale_y", np.float32), ("scale_x", np.float32)], align=True)
assert MAP_DTYPE.itemsize == 48

_SIGNATURES = {
    "x3d_clip_prep": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int] + [ctypes.c_float] * 6
    + [ctypes.c_void_p, ctypes.c_void_p],
}
_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}
_CHUNK = 64                 # clip frames a step of the plain version


def _check(arena, table, shape, dtype):
    if arena.dtype != torch.uint8 or arena.dim() != 1:
        raise ValueError("the arena is a flat uint8 tensor")
    if table.dtype != MAP_DTYPE:
        raise ValueError("the map table has dtype MAP_DTYPE")
    N, T, S, S2, C = shape
    if S != S2 or C != 3 or len(table) != N * T:
        raise ValueError(f"output {tuple(shape)} needs (N, T, S, S, 3) and "
                         f"N * T map rows, got {len(table)}")
    if dtype not in _OUT_KINDS:
        raise TypeError(f"output dtype float32, bfloat16 or uint8, "
                        f"got {dtype}")


def _taps(i, off, scale, win):
    """tf.image.resize's interpolation of one axis: (M, S) lower and upper
    taps and lerps for output indices ``i`` (M, S), or (1, S) for all."""
    pos = ((i + off[:, None]).to(torch.float32) + 0.5) \
        * scale[:, None] - 0.5
    f = torch.floor(pos)
    lo = torch.minimum(f.to(torch.int64).clamp(min=0), win[:, None] - 1)
    hi = torch.minimum(torch.ceil(pos).to(torch.int64), win[:, None] - 1)
    return lo, hi, pos - f


def clip_prep_reference(arena, table, shape, dtype=torch.bfloat16,
                        mean: Sequence[float] = (0.0, 0.0, 0.0),
                        std: Sequence[float] = (1.0, 1.0, 1.0)):
    """Plain version of :func:`clip_prep` (``table['src']`` is the frame's
    byte offset in ``arena``)."""
    _check(arena, table, shape, dtype)
    N, T, S = shape[:3]
    dev = arena.device
    cols = {k: torch.from_numpy(np.ascontiguousarray(table[k])).to(dev)
            for k in MAP_DTYPE.names}
    cols = {k: v.to(torch.int64) if v.dtype == torch.int32 else v
            for k, v in cols.items()}
    i = torch.arange(S, device=dev)
    flip = cols["flip"][:, None] != 0
    y0, y1, ly = _taps(i[None, :], cols["off_y"], cols["scale_y"],
                       cols["win_h"])
    xs = torch.where(flip, S - 1 - i[None, :], i[None, :])
    x0, x1, lx = _taps(xs, cols["off_x"], cols["scale_x"], cols["win_w"])
    rows0 = cols["src"][:, None] + (cols["win_y"][:, None] + y0) \
        * cols["pitch"][:, None]
    rows1 = cols["src"][:, None] + (cols["win_y"][:, None] + y1) \
        * cols["pitch"][:, None]
    c0 = (cols["win_x"][:, None] + x0) * 3
    c1 = (cols["win_x"][:, None] + x1) * 3
    ch = torch.arange(3, device=dev)
    mean_t = torch.tensor(mean, dtype=torch.float32, device=dev)
    std_t = torch.tensor(std, dtype=torch.float32, device=dev)
    # a tensor, not a scalar: PyTorch's CUDA division by a scalar
    # multiplies by its reciprocal, which rounds otherwise
    full255 = torch.full((), 255.0, device=dev)
    out = torch.empty(tuple(shape), dtype=dtype, device=dev)
    flat = out.view(N * T, S, S, 3)
    for a in range(0, N * T, _CHUNK):
        b = min(a + _CHUNK, N * T)

        def tap(rows, c):
            idx = rows[a:b, :, None, None] + c[a:b, None, :, None] \
                + ch[None, None, None, :]
            return arena[idx].to(torch.float32)

        lxb = lx[a:b, None, :, None]
        lyb = ly[a:b, :, None, None]
        tl, tr = tap(rows0, c0), tap(rows0, c1)
        bl, br = tap(rows1, c0), tap(rows1, c1)
        top = tl + (tr - tl) * lxb
        bot = bl + (br - bl) * lxb
        u8 = (top + (bot - top) * lyb).to(torch.uint8)
        if dtype == torch.uint8:
            flat[a:b] = u8
        else:
            x = u8.to(torch.float32) / full255
            flat[a:b] = ((x - mean_t) / std_t).to(dtype)
    return out


def clip_prep(arena, table, shape, dtype=torch.bfloat16,
              mean: Sequence[float] = (0.0, 0.0, 0.0),
              std: Sequence[float] = (1.0, 1.0, 1.0)):
    """The batch (N, T, S, S, 3) in ``dtype`` sampled from the decoded
    frames in ``arena`` by the maps in ``table`` (numpy, MAP_DTYPE, one row
    a clip frame, ``src`` the frame's byte offset in the arena).

    bfloat16 and float32 outputs are normalised with ``mean`` and ``std``
    (per channel, on the 0-1 scale); uint8 is the truncated sample.  A CPU
    arena takes the plain version; a CUDA arena launches the clip kernel
    or raises.
    """
    _check(arena, table, shape, dtype)
    if arena.device.type == "cpu":
        return clip_prep_reference(arena, table, shape, dtype, mean, std)
    kernels.check_cuda(arena)
    M, S = len(table), shape[2]
    if M > 65535:
        raise ValueError(f"{M} clip frames: at most 65535 a call")
    maps = table.copy()
    maps["src"] += arena.data_ptr()
    maps_dev = torch.from_numpy(maps.view(np.uint8)).to(arena.device,
                                                        non_blocking=False)
    out = torch.empty(tuple(shape), dtype=dtype, device=arena.device)
    lib = _build.load("clip_prep.cu", _SIGNATURES)
    rc = lib.x3d_clip_prep(maps_dev.data_ptr(), M, S, _OUT_KINDS[dtype],
                           *[float(v) for v in mean], *[float(v) for v in std],
                           out.data_ptr(), kernels.stream_handle(arena))
    kernels.raise_on_error(rc, "clip_prep kernel launch")
    clip_prep.launches += 1
    return out


clip_prep.launches = 0


def bound_bytes(table, shape, dtype) -> int:
    """Bytes the clip kernel must move: each decoded frame's sampled
    rectangle read once (the bounding box of its clip frames' taps) and the
    batch written once."""
    S = shape[2]
    i = np.arange(S)
    boxes = {}
    for r in table:
        def span(off, scale, win, idx):
            pos = ((idx + off).astype(np.float32) + np.float32(0.5)) \
                * np.float32(scale) - np.float32(0.5)
            lo = max(int(np.floor(pos.min())), 0)
            hi = min(int(np.ceil(pos.max())), win - 1)
            return lo, hi
        y = span(r["off_y"], r["scale_y"], r["win_h"], i)
        x = span(r["off_x"], r["scale_x"], r["win_w"], i)
        key = int(r["src"])
        y = (y[0] + r["win_y"], y[1] + r["win_y"])
        x = (x[0] + r["win_x"], x[1] + r["win_x"])
        if key in boxes:
            (a0, a1), (b0, b1) = boxes[key]
            y = (min(a0, y[0]), max(a1, y[1]))
            x = (min(b0, x[0]), max(b1, x[1]))
        boxes[key] = (y, x)
    read = sum((y1 - y0 + 1) * (x1 - x0 + 1) * 3
               for (y0, y1), (x0, x1) in boxes.values())
    itemsize = torch.empty((), dtype=dtype).element_size()
    return int(read + np.prod(shape) * itemsize)
