"""Fused bottleneck segment: BN affine + ReLU -> depthwise conv -> BN sums.

    y = dwconv3d(relu(a*x + b), k),  p = sum_thw(y),  s2 = sum_thw(y^2)

:func:`dw_bn_act_conv` is the wrapper of the hand-written CUDA kernel K2
(``kernels/csrc/dw_fused.cu``), which replaces the TPU kernel
``dw_fused._fwd_kernel`` of the JAX package; :func:`reference` is its plain
PyTorch version.  :func:`dw_bn_act_conv_bwd` is the wrapper of K3
(``kernels/csrc/dw_fused_bwd.cu``), the one-pass backward, which replaces
``dw_fused._bwd_kernel``; :func:`bwd_reference` is its plain version.  K2
and K3 have two bodies each, picked by :func:`segment_body`: a ring body for
3x3 spatial taps and up to 5 temporal ones (every fused segment of X3D),
launched by the plan :func:`fwd_plan` or :func:`bwd_plan` gives, and a
generic body for other taps.
:func:`segment` is the differentiable op the model calls (K2 forward, K3
backward, or the plain versions within ``ops.plain_versions()``).
:func:`fwd_cost` and :func:`bwd_cost` give a call's least bytes and
operations, which the wrappers write into an open ``ops.launch_log``.

* ``a, b`` are (C, B) float32 normalise coefficients, one column per
  sample, computed outside from running (or, in training, batch)
  statistics.  Serving passes constant columns; per-sample columns are what
  per-replica BN will need.
* ``p``/``s2`` are per-(channel, sample) float32 sums over (T, H, W) of y
  as stored in x's dtype.  In serving, ``p`` gives the Squeeze-Excite pool.
* Stride 1, SAME padding, odd kernel dims, any T (fewer frames than
  temporal taps too: multigrid's coarse phases give X3D-XS 1 and 2 frames
  under 3 taps).  Out-of-image and out-of-clip elements of u = relu(a*x +
  b) are zero.
* In eval, bn_b's affine rides K2 as its epilogue (``mul``, ``add``:
  ``ops/epilogue.py``): y is stored through it, while ``p`` and ``s2``
  stay the sums of the conv's output (the SE pool is taken from them).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from x3d_tpu_torch import kernels, ops
from x3d_tpu_torch.kernels import _build
from x3d_tpu_torch.ops import epilogue
from x3d_tpu_torch.ops.depthwise import (depthwise_conv3d_dk_reference,
                                         depthwise_conv3d_reference,
                                         same_pads)
from x3d_tpu_torch.ops.ring import (RING_AHEAD, RING_MAX_KT,
                                    RING_MAX_THREADS, align, card_slots,
                                    ring_slot, taps_smem)
from x3d_tpu_torch.ops.ring import plan as ring_plan

_SIGNATURES = {
    "x3d_dw_bn_act_conv_tiles": [ctypes.c_int] * 3,
    "x3d_dw_bn_act_conv_fwd": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
    + epilogue.ARGTYPES,
    "x3d_dw_bn_act_conv_fwd_ring_occupancy": [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    "x3d_dw_bn_act_conv_fwd_ring": [ctypes.c_void_p] * 9
    + [ctypes.c_int] * 16 + epilogue.ARGTYPES,
}
_BWD_SIGNATURES = {
    "x3d_dw_bn_act_conv_bwd_tiles": [ctypes.c_int] * 2,
    "x3d_dw_bn_act_conv_bwd": [ctypes.c_void_p] * 15 + [ctypes.c_int] * 9
    + [ctypes.c_void_p],
    "x3d_dw_bn_act_conv_bwd_ring_occupancy": [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    "x3d_dw_bn_act_conv_bwd_ring": [ctypes.c_void_p] * 15
    + [ctypes.c_int] * 16 + [ctypes.c_void_p],
}


def fwd_cost(x_shape, kdims, elem: int) -> Tuple[int, int]:
    """K2's (bytes, flops): x read and y written, the (C, B) columns a, b
    read and p, s2 written (float32), the float32 taps read; per output the
    taps' multiply-adds, the affine, the ReLU and the two sums."""
    n, C, B = math.prod(x_shape), x_shape[-1], x_shape[0]
    taps = math.prod(int(k) for k in kdims)
    return 2 * n * elem + 4 * C * B * 4 + taps * C * 4, (2 * taps + 5) * n


def bwd_cost(x_shape, kdims, elem: int) -> Tuple[int, int]:
    """K3's (bytes, flops): x, y and the cotangent read and dx written, the
    taps read and dk written (float32), the columns a, b, gp, gs2 read and
    dzs, duu written (float32); per element both products of the conv's
    backward and the affine, ReLU and sums around them."""
    n, C, B = math.prod(x_shape), x_shape[-1], x_shape[0]
    taps = math.prod(int(k) for k in kdims)
    return (4 * n * elem + taps * C * 8 + 6 * C * B * 4,
            (4 * taps + 12) * n)


def _log(kernel, body, x, kdims, direction, cost, bn="none") -> None:
    ops.log_launch(kernel, body, {"taps": [int(k) for k in kdims],
                                  "C": int(x.shape[-1])}, direction,
                   x.dtype, cost, bn)


def _dims(x, kernel):
    B, T, H, W, C = x.shape
    kt, kh, kw = kernel.shape[:3]
    if kt % 2 == 0 or kh % 2 == 0 or kw % 2 == 0:
        raise ValueError("dw_fused supports odd kernel dims only")
    return B, T, H, W, C, kt, kh, kw


def _check(x, a_cb, b_cb, kernel):
    if x.dim() != 5 or kernel.dim() != 5 or kernel.shape[3] != 1 \
            or kernel.shape[4] != x.shape[4]:
        raise ValueError(
            f"expected x (B,T,H,W,C) and taps (kt,kh,kw,1,C), got "
            f"{tuple(x.shape)} and {tuple(kernel.shape)}")
    dims = _dims(x, kernel)
    want = (x.shape[4], x.shape[0])
    if tuple(a_cb.shape) != want or tuple(b_cb.shape) != want:
        raise ValueError(f"coefficient columns must be (C, B) = {want}, got "
                         f"{tuple(a_cb.shape)} and {tuple(b_cb.shape)}")
    return dims


def reference(x, a_cb, b_cb, kernel):
    """Plain version with the kernel's semantics."""
    B, T, H, W, C, kt, kh, kw = _check(x, a_cb, b_cb, kernel)
    u = _relu_affine(x, a_cb, b_cb)
    y = depthwise_conv3d_reference(u, kernel.to(u.dtype), (1, 1, 1),
                                   _same(T, H, W, kt, kh, kw))
    y32 = y.to(torch.float32)
    # (C, B) laid out as the kernel's; clone, where contiguous() would
    # guard an exported batch against 1
    p = y32.sum(dim=(1, 2, 3)).t().clone(memory_format=torch.contiguous_format)
    s2 = (y32 * y32).sum(dim=(1, 2, 3)).t().clone(
        memory_format=torch.contiguous_format)
    return y, p, s2


def _launch_fwd(lib, body, x, a, b, taps, kdims, stream,
                bn=epilogue.NO_POINTERS):
    """K2's ``body`` on contiguous tensors of one device (float32 columns
    and taps), with the epilogue's (mul, add, relu) arguments ``bn``
    (``epilogue.pointers``); returns (y, p, s2) or raises."""
    B, T, H, W, C = x.shape
    kt, kh, kw = kdims
    code = kernels.dtype_code(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    p = torch.empty((C, B), **f32)
    s2 = torch.empty_like(p)
    ptrs = [x.data_ptr(), a.data_ptr(), b.data_ptr(), taps.data_ptr(),
            y.data_ptr()]
    if body == "ring":
        q = _fwd_ring_plan(lib, x, kt)
        part = torch.empty((2, q["parts"] // B, C, B), **f32)
        rc = lib.x3d_dw_bn_act_conv_fwd_ring(
            *ptrs, part[0].data_ptr(), part[1].data_ptr(), p.data_ptr(),
            s2.data_ptr(), code, B, T, H, W, C, kt, q["tile_h"], q["tile_w"],
            q["group"], q["vec"], q["rows"], q["run"], q["granule"],
            q["row_cells"], q["vec_pad"], *bn, stream)
    else:
        tiles = lib.x3d_dw_bn_act_conv_tiles(T, H, W)
        part = torch.empty((2, B, tiles, C), **f32)
        rc = lib.x3d_dw_bn_act_conv_fwd(
            *ptrs, part[0].data_ptr(), part[1].data_ptr(), p.data_ptr(),
            s2.data_ptr(), code, B, T, H, W, C, kt, kh, kw, *bn, stream)
    kernels.raise_on_error(rc, f"dw_bn_act_conv ({body} body) kernel launch")
    return y, p, s2


def dw_bn_act_conv(x, a_cb, b_cb, kernel, mul=None, add=None, relu=False):
    """y = dwconv(relu(a*x + b), kernel); p = sum_thw y; s2 = sum_thw y^2.

    Args:
      x: (B, T, H, W, C) raw (pre-BN) input, float32 or bfloat16.
      a_cb, b_cb: (C, B) float32 normalise coefficients.
      kernel: (kt, kh, kw, 1, C) depthwise taps (odd dims, stride 1, SAME),
        rounded to x's dtype; the kernel sums taps in float32.
      mul, add: (C,) float32, an eval BatchNorm applied to y as it is
        stored, and ``relu`` a ReLU after it (``ops/epilogue.py``).

    Returns:
      y: (B, T, H, W, C) in x.dtype (through the epilogue where one is
      given);  p, s2: (C, B) float32, the sums of the conv's y.

    A CPU tensor takes the plain version; a CUDA tensor launches K2's body
    that :func:`segment_body` names, or raises.
    """
    B, T, H, W, C, kt, kh, kw = _check(x, a_cb, b_cb, kernel)
    epilogue.check(mul, add, relu, C)
    bn = epilogue.kind(mul, relu)
    if x.device.type == "cpu":
        body = "plain"
        y, p, s2 = reference(x, a_cb, b_cb, kernel)
        y = epilogue.reference(y, mul, add, relu)
    else:
        kernels.check_cuda(x)
        a = a_cb.to(torch.float32).contiguous()
        b = b_cb.to(torch.float32).contiguous()
        taps = kernel.to(x.dtype).to(torch.float32).reshape(kt * kh * kw, C)
        taps = taps.contiguous()
        coefs = epilogue.prepare(mul, add, x)
        kernels.check_cuda(x, a, b, taps, *(coefs or ()))
        body = segment_body((kt, kh, kw))
        lib = epilogue.library("dw_fused.cu", _SIGNATURES, coefs)
        y, p, s2 = _launch_fwd(lib, body, x, a, b, taps, (kt, kh, kw),
                               kernels.stream_handle(x),
                               epilogue.pointers(coefs, relu))
        dw_bn_act_conv.launches += 1
        dw_bn_act_conv.body_launches[body] += 1
        if coefs is not None:
            dw_bn_act_conv.epilogue_launches[bn] += 1
    if ops.records is not None:
        _log("K2", body, x, (kt, kh, kw), "fwd", epilogue.cost(
            bn, C, x.numel(), fwd_cost(x.shape, (kt, kh, kw),
                                       x.element_size())), bn)
    return y, p, s2


dw_bn_act_conv.launches = 0
dw_bn_act_conv.body_launches = {"ring": 0, "generic": 0}
dw_bn_act_conv.epilogue_launches = epilogue.counter()


# ---------------------------------------------------------- K3: backward


def _columns(cb):
    """(C, B) float32 columns -> (B, 1, 1, 1, C), broadcastable over x (a
    view: no reshape, which would guard an exported batch against 1)."""
    return cb.t().to(torch.float32)[:, None, None, None, :]


def _relu_affine(x, a_cb, b_cb):
    """u = relu(a*x + b) in float32, rounded to x's dtype."""
    u = x.to(torch.float32) * _columns(a_cb) + _columns(b_cb)
    return torch.relu(u).to(x.dtype)


def _same(T, H, W, kt, kh, kw):
    return tuple(same_pads(n, k, 1) for n, k in zip((T, H, W), (kt, kh, kw)))


def _g_eff(gy, gp, gs2, y):
    """g = (gy + gp) + 2 gs2 * y in float32, rounded to y's dtype: the
    cotangent of y once the sums' cotangents are folded in."""
    g = gy.to(torch.float32) + _columns(gp)
    return (g + _columns(2.0 * gs2) * y.to(torch.float32)).to(y.dtype)


def bwd_reference(x, a_cb, b_cb, kernel, y, gy, gp, gs2):
    """Plain version of K3: (dx, dk, dzs, duu) with the kernel's semantics.

    dx (B, T, H, W, C) in x's dtype; dk (kt, kh, kw, 1, C) float32; dzs =
    sum_thw dz and duu = sum_thw dz * u, (C, B) float32, where u =
    relu(a*x + b) and dz = conv(g, flip(k)) where u > 0.
    """
    B, T, H, W, C, kt, kh, kw = _check(x, a_cb, b_cb, kernel)
    a = _columns(a_cb)
    u = _relu_affine(x, a_cb, b_cb)
    g = _g_eff(gy, gp, gs2, y)
    pads = _same(T, H, W, kt, kh, kw)
    flipped = kernel.to(x.dtype).to(torch.float32).flip(0, 1, 2)
    du = depthwise_conv3d_reference(g.to(torch.float32), flipped, (1, 1, 1),
                                    pads)
    u32 = u.to(torch.float32)
    dz = torch.where(u32 > 0, du, torch.zeros_like(du))
    dx = (dz * a).to(x.dtype)
    dk = depthwise_conv3d_dk_reference(u, g, (kt, kh, kw), (1, 1, 1), pads)
    dzs = dz.sum(dim=(1, 2, 3)).t().contiguous()
    duu = (dz * u32).sum(dim=(1, 2, 3)).t().contiguous()
    return dx, dk, dzs, duu


def bwd_abs_sums(x, a_cb, b_cb, kernel, y, gy, gp, gs2):
    """The sums of :func:`bwd_reference` (dk, dzs, duu) taken over absolute
    values -- |u| |g| per tap, and |du| = conv(|g|, |k|) with |du| |u| --
    the scale against which the rounding of those sums is judged."""
    B, T, H, W, C, kt, kh, kw = _check(x, a_cb, b_cb, kernel)
    u = _relu_affine(x, a_cb, b_cb).to(torch.float32)
    g = _g_eff(gy, gp, gs2, y).to(torch.float32).abs()
    pads = _same(T, H, W, kt, kh, kw)
    du = depthwise_conv3d_reference(
        g, kernel.to(torch.float32).abs().flip(0, 1, 2), (1, 1, 1), pads)
    dk = depthwise_conv3d_dk_reference(u, g, (kt, kh, kw), (1, 1, 1), pads)
    return (dk, du.sum(dim=(1, 2, 3)).t(), (du * u).sum(dim=(1, 2, 3)).t())


# ------------------------------------------- the ring bodies' plans (K2, K3)

# The limits and rules K2's and K3's ring bodies share with K1's live in
# ops/ring; these are K2's and K3's own.
RING_SMEM = 113 * 1024    # K3: a block's shared memory: two blocks an SM
FWD_SMEM = 72 * 1024      # K2: the most shared memory a block takes


def segment_body(kdims) -> str:
    """Which of their two bodies K2 and K3 run for a call: "ring" for
    spatial taps 3x3 and 1 <= kt <= RING_MAX_KT (every fused segment of
    X3D), "generic" for every other geometry."""
    kt, kh, kw = (int(k) for k in kdims)
    return "ring" if (kh, kw) == (3, 3) and 1 <= kt <= RING_MAX_KT \
        else "generic"


def _ring_smem(kt, vec, elem, tile_h, row_cells, vec_pad, group,
               rows) -> int:
    """Dynamic shared memory of a K3 ring-body block, as ``ring_smem`` in
    dw_fused_bwd.cu lays it out."""
    slot = ring_slot(group // vec, vec, elem, tile_h, row_cells, vec_pad)
    ring = (2 * (kt + RING_AHEAD) + RING_AHEAD + 1) * slot
    red = rows * (9 * kt + 2) * group * 4
    return -(-max(ring, red) // 16) * 16 + taps_smem(kt, vec, group)


def _fwd_smem(kt, vec, elem, tile_h, row_cells, vec_pad, group,
              rows) -> int:
    """Dynamic shared memory of a K2 ring-body block, as ``ring_smem`` in
    dw_fused.cu lays it out: kt + RING_AHEAD slots of x (then u), after the
    frames the rows' two sums."""
    slot = ring_slot(group // vec, vec, elem, tile_h, row_cells, vec_pad)
    ring = (kt + RING_AHEAD) * slot
    red = rows * 2 * group * 4
    return -(-max(ring, red) // 16) * 16 + taps_smem(kt, vec, group)


@functools.lru_cache(maxsize=None)
def bwd_plan(B: int, T: int, H: int, W: int, C: int, kt: int, elem: int = 2,
             align: int = 16, slots: int = 0) -> dict:
    """How K3's ring body runs a call: elements of ``elem`` bytes, inputs
    whose addresses are multiples of ``align`` bytes, a card that holds
    ``slots`` blocks at once (0: no runs are cut).

    * the copy granule: a cell (``vec`` channels of one pixel, 4 or 8 bytes)
      where every address allows it, else one element (plain loads);
    * the tile: :func:`ring.ring_side` along H and along W;
    * channel groups of ``vec`` channels a vector (2 at even C), at most
      RING_MAX_VECS vectors, as even as they come, and small enough for
      RING_SMEM bytes of shared memory: every group starts on a cell;
    * thread rows: each takes tile rows r, r + rows, ... in each of the
      block's two roles (du and dk), a role at most RING_MAX_THREADS
      threads and whole warps;
    * the ring's row and vector-plane pitches, so that a warp's loads fall
      on distinct shared-memory banks (:func:`ring.ring_pitch`);
    * runs of ``run`` frames: T is cut while the blocks would not fill the
      card twice over, keeping runs of RING_MIN_RUN frames or more.
    """
    p = ring_plan(B, T, H, W, C, elem, align, slots, RING_MAX_THREADS,
                  RING_SMEM,
                  lambda vec, *rest: _ring_smem(kt, vec, elem, *rest))
    p["threads"] = 2 * 32 * p.pop("warps")
    return p


@functools.lru_cache(maxsize=None)
def fwd_plan(B: int, T: int, H: int, W: int, C: int, kt: int, elem: int = 2,
             align: int = 16, slots: int = 0) -> dict:
    """How K2's ring body runs a call, by :func:`bwd_plan`'s rules (x's
    address is the one ``align`` counts), with one role and at most
    FWD_SMEM bytes of shared memory a block: the ring's kt + RING_AHEAD
    slots of one array, or after the frames the rows' two sums, and the
    taps where they do not fit in registers.  A group has at most
    RING_MAX_THREADS // tile_h vectors, so that each thread takes one tile
    row: more, smaller blocks, four an SM."""
    p = ring_plan(B, T, H, W, C, elem, align, slots, RING_MAX_THREADS,
                  FWD_SMEM, lambda vec, *rest: _fwd_smem(kt, vec, elem, *rest),
                  row_a_thread=True)
    p["threads"] = 32 * p.pop("warps")
    return p


def _ring_slots(lib, body: str, code: int, vec: int, kt: int, threads: int,
                smem: int) -> int:
    """Blocks of this shape of K2's (``body`` "fwd") or K3's ("bwd") ring
    body that the card holds at once (blocks an SM x SMs)."""
    return card_slots(lib, f"x3d_dw_bn_act_conv_{body}_ring_occupancy",
                      code, vec, kt, threads, smem)


def _fwd_ring_plan(lib, x, kt: int) -> dict:
    """:func:`fwd_plan` for a ring-body call on x and this card (its blocks
    at once from the library's occupancy query)."""
    B, T, H, W, C = x.shape
    args = (B, T, H, W, C, kt, x.element_size(), align(x))
    p = fwd_plan(*args)
    return fwd_plan(*args, slots=_ring_slots(
        lib, "fwd", kernels.dtype_code(x), p["vec"], kt, p["threads"],
        p["smem_bytes"]))


def _ring_plan(lib, x, y, gy, kt: int) -> dict:
    """:func:`bwd_plan` for a ring-body call on these tensors and this card
    (its blocks at once from the library's occupancy query)."""
    B, T, H, W, C = x.shape
    args = (B, T, H, W, C, kt, x.element_size(), align(x, y, gy))
    p = bwd_plan(*args)
    return bwd_plan(*args, slots=_ring_slots(
        lib, "bwd", kernels.dtype_code(x), p["vec"], kt, p["threads"],
        p["smem_bytes"]))


def _launch_bwd(lib, body, x, cols, taps, y, gy, kdims, stream):
    """K3's ``body`` on contiguous tensors of one device (float32 columns
    and taps, y and gy in x's dtype); returns (dx, dk (taps, C), dzs, duu)
    or raises."""
    B, T, H, W, C = x.shape
    kt, kh, kw = kdims
    ntaps = kt * kh * kw
    code = kernels.dtype_code(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dk = torch.empty((ntaps, C), **f32)
    dzs = torch.empty((C, B), **f32)
    duu = torch.empty_like(dzs)
    ptrs = [x.data_ptr(), y.data_ptr(), gy.data_ptr(),
            *(t.data_ptr() for t in cols), taps.data_ptr(), dx.data_ptr()]
    if body == "ring":
        p = _ring_plan(lib, x, y, gy, kt)
        subs = p["parts"] // B
        part_dk = torch.empty((p["parts"], ntaps, C), **f32)
        part_dzs = torch.empty((subs, C, B), **f32)
        part_duu = torch.empty_like(part_dzs)
        rc = lib.x3d_dw_bn_act_conv_bwd_ring(
            *ptrs, part_dk.data_ptr(), part_dzs.data_ptr(),
            part_duu.data_ptr(), dk.data_ptr(), dzs.data_ptr(),
            duu.data_ptr(), code, B, T, H, W, C, kt, p["tile_h"],
            p["tile_w"], p["group"], p["vec"], p["rows"], p["run"],
            p["granule"], p["row_cells"], p["vec_pad"], stream)
    else:
        tiles = lib.x3d_dw_bn_act_conv_bwd_tiles(H, W)
        part_dk = torch.empty((B, tiles, ntaps, C), **f32)
        part_dzs = torch.empty((B, tiles, C), **f32)
        part_duu = torch.empty_like(part_dzs)
        rc = lib.x3d_dw_bn_act_conv_bwd(
            *ptrs, part_dk.data_ptr(), part_dzs.data_ptr(),
            part_duu.data_ptr(), dk.data_ptr(), dzs.data_ptr(),
            duu.data_ptr(), code, B, T, H, W, C, kt, kh, kw, stream)
    kernels.raise_on_error(rc, f"dw_bn_act_conv_bwd ({body} body) kernel "
                           "launch")
    return dx, dk, dzs, duu


def dw_bn_act_conv_bwd(x, a_cb, b_cb, kernel, y, gy, gp, gs2):
    """The backward of :func:`dw_bn_act_conv` in one pass (kernel K3).

    Args:
      x, a_cb, b_cb, kernel: the forward's inputs; y its output.
      gy: (B, T, H, W, C) cotangent of y, in x's dtype.
      gp, gs2: (C, B) float32 cotangents of p and s2.

    Returns:
      dx (B, T, H, W, C) in x's dtype; dk (kt, kh, kw, 1, C) float32; dzs,
      duu (C, B) float32 (see :func:`bwd_reference`).

    A CPU tensor takes the plain version; a CUDA tensor launches K3's body
    that :func:`segment_body` names, or raises.
    """
    B, T, H, W, C, kt, kh, kw = _check(x, a_cb, b_cb, kernel)
    if tuple(y.shape) != tuple(x.shape) or tuple(gy.shape) != tuple(x.shape):
        raise ValueError("y and its cotangent must have x's shape")
    if x.device.type == "cpu":
        body = "plain"
        out = bwd_reference(x, a_cb, b_cb, kernel, y, gy, gp, gs2)
    else:
        kernels.check_cuda(x)
        cols = [t.to(torch.float32).contiguous()
                for t in (a_cb, b_cb, gp, gs2)]
        taps = kernel.to(x.dtype).to(torch.float32).reshape(kt * kh * kw, C)
        taps = taps.contiguous()
        y, gy = y.to(x.dtype).contiguous(), gy.to(x.dtype).contiguous()
        kernels.check_cuda(x, y, gy, *cols, taps)
        body = segment_body((kt, kh, kw))
        lib = _build.load("dw_fused_bwd.cu", _BWD_SIGNATURES)
        dx, dk, dzs, duu = _launch_bwd(lib, body, x, cols, taps, y, gy,
                                       (kt, kh, kw), kernels.stream_handle(x))
        dw_bn_act_conv_bwd.launches += 1
        dw_bn_act_conv_bwd.body_launches[body] += 1
        out = dx, dk.reshape(kt, kh, kw, 1, C), dzs, duu
    if ops.records is not None:
        _log("K3", body, x, (kt, kh, kw), "bwd",
             bwd_cost(x.shape, (kt, kh, kw), x.element_size()))
    return out


dw_bn_act_conv_bwd.launches = 0
dw_bn_act_conv_bwd.body_launches = {"ring": 0, "generic": 0}


class _Segment(torch.autograd.Function):
    """K2 forward, K3 backward; within ``ops.plain_versions()`` both run
    their plain versions.  Where ``ops.via_library()`` holds (export, a
    remat "convs" region) the forward is the op ``x3d::dw_bn_act_conv``
    (``ops/library.py``).  Unused outputs'
    cotangents arrive as None (in training s2 feeds BN only and the SE
    pool reads p alone) and count as zeros."""

    @staticmethod
    def forward(ctx, x, a_cb, b_cb, kernel):
        ctx.set_materialize_grads(False)
        if ops.plain_versions_enabled():
            fwd = reference
        elif ops.via_library():
            from x3d_tpu_torch.ops import library
            fwd = library.dw_bn_act_conv
        else:
            fwd = dw_bn_act_conv
        y, p, s2 = fwd(x, a_cb, b_cb, kernel)
        ctx.save_for_backward(x, a_cb, b_cb, kernel, y)
        return y, p, s2

    @staticmethod
    def backward(ctx, gy, gp, gs2):
        x, a_cb, b_cb, kernel, y = ctx.saved_tensors
        gy = torch.zeros_like(y) if gy is None else gy
        gp = torch.zeros_like(a_cb) if gp is None else gp
        gs2 = torch.zeros_like(a_cb) if gs2 is None else gs2
        bwd = bwd_reference if ops.plain_versions_enabled() \
            else dw_bn_act_conv_bwd
        dx, dk, dzs, duu = bwd(x, a_cb, b_cb, kernel, y, gy, gp, gs2)
        # da = sum dz * x, with x = (u - b) / a where dz != 0; undefined
        # (and set to 0) where a == 0, as the JAX rule does
        zero = torch.zeros_like(duu)
        safe = torch.where(a_cb != 0, a_cb, torch.ones_like(a_cb))
        da = torch.where(a_cb != 0, (duu - b_cb * dzs) / safe, zero)
        return dx, da, dzs, dk.to(kernel.dtype)


def segment(x, a_cb, b_cb, kernel, mul=None, add=None, relu=False):
    """The differentiable fused segment: (y, p, s2) as
    :func:`dw_bn_act_conv`, with gradients for x, both coefficient columns
    and the taps (float32 parameters).  ``mul``, ``add`` and ``relu``: an
    eval BatchNorm on y (``ops/epilogue.py``; forward only), K2's epilogue
    where K2 runs, else the plain version after the segment."""
    if not torch.compiler.is_exporting():
        # once here, not in K2's and again in K3's wrapper; an exported
        # batch leaves it to the op (contiguous() would guard it against 1)
        a_cb, b_cb = a_cb.contiguous(), b_cb.contiguous()
    if mul is None:
        return _Segment.apply(x.contiguous(), a_cb, b_cb, kernel)
    epilogue.forward_only(mul, x, a_cb, b_cb, kernel, add)
    if ops.plain_versions_enabled():
        y, p, s2 = reference(x, a_cb, b_cb, kernel)
        return epilogue.reference(y, mul, add, relu), p, s2
    if ops.via_library():
        from x3d_tpu_torch.ops import library
        return library.dw_bn_act_conv(x.contiguous(), a_cb, b_cb, kernel,
                                      mul, add, relu)
    return dw_bn_act_conv(x.contiguous(), a_cb, b_cb, kernel, mul, add, relu)
