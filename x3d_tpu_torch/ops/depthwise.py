"""Depthwise (channelwise) 3-D convolution on NDHWC activations.

The X3D bottleneck's T×3×3 ``groups=C`` conv, the stem's k×1×1 temporal
conv, and the stride-2 stage-entry convs.

* :func:`depthwise_conv3d` is the wrapper of the hand-written CUDA kernel K1
  (``kernels/csrc/depthwise.cu``), which replaces the TPU kernels
  ``dw_batchminor._fwd_kernel`` and ``pallas_dw._fwd_kernel``;
  :func:`depthwise_conv3d_reference` is its plain PyTorch version.  K1 has
  three bodies, picked by :func:`fwd_body`: the temporal body for 1x1
  spatial taps at stride 1 (the stem's k×1×1 conv; a thread walks one
  pixel's channel cell through a run of frames, the sums in registers,
  launched by :func:`temporal_plan`), the ring body for 3x3 spatial taps at
  spatial stride 1 or 2 (the stride-2 stage entries; K2's ring staging,
  launched by :func:`ring_plan`), and the generic body for every other
  geometry.
* :func:`depthwise_conv3d_dx` and :func:`depthwise_conv3d_dk` are the
  wrappers of kernel K4 (``kernels/csrc/depthwise_bwd.cu``), the backward,
  which replaces the TPU kernels ``dw_batchminor._dk_kernel`` and
  ``pallas_dw._dk_kernel`` (and their dx, which reran the forward); each has
  its plain version beside it.  dx has two bodies, picked by
  :func:`dx_body`: the parity-phase body at the stride-2 stage entries and
  the gather body for every other geometry; dk two, picked by
  :func:`dk_body`: the ring body for 3x3 spatial taps at spatial stride 1
  or 2 (the stride-2 stage entries; K1's ring staging, launched by
  :func:`dk_ring_plan`) and the generic body for every other geometry.
* :func:`depthwise_conv3d_pbwd` is the wrapper of kernel K8
  (``kernels/csrc/depthwise_pbwd.cu``), the one-pass backward of a stride-1
  SAME odd-tap conv (both gradients from one stream over the input and the
  cotangent), which replaces the TPU kernel ``dw_fused._pbwd_kernel``;
  :func:`depthwise_conv3d_pbwd_reference` is its plain version.  K8 has
  two bodies, picked by :func:`pbwd_body`: the temporal body for 1x1
  spatial taps (the stem's k×1×1 conv; a thread walks one pixel's channel
  cell through a run of frames, du and the dk sums in registers, one
  partial a block summed in a fixed order, launched by
  :func:`pbwd_temporal_plan`) and the generic body for every other
  geometry.
* :func:`depthwise` is the differentiable op the model calls: K1 forward;
  backward K8 where :func:`pbwd_eligible` holds and both gradients are
  wanted, else K4 (or the plain versions, see ``ops.plain_versions``).
* :func:`fwd_cost`, :func:`bwd_cost` and :func:`pbwd_cost` give a call's
  least bytes and operations (K1; K4 dx and dk; K8), which the wrappers
  write into an open ``ops.launch_log``.

Taps keep the Flax layout ``(k_t, k_h, k_w, 1, C)``.  Padding follows
TF/XLA "SAME", which puts the odd pad element on the high side
(:func:`same_pads`): at stride 2 PyTorch's symmetric ``padding=1`` would
shift the sampling grid, so pads are always explicit (lo, hi) pairs.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from x3d_tpu_torch import kernels, ops
from x3d_tpu_torch.kernels import _build
from x3d_tpu_torch.ops import epilogue, ring

Pads = Tuple[Tuple[int, int], Tuple[int, int], Tuple[int, int]]

_SIGNATURES = {
    "x3d_dw_conv3d_fwd": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 18
    + epilogue.ARGTYPES,
    "x3d_dw_conv3d_fwd_temporal_occupancy": [ctypes.c_int] * 3
    + [ctypes.c_void_p],
    "x3d_dw_conv3d_fwd_temporal": [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 11 + epilogue.ARGTYPES,
    "x3d_dw_conv3d_fwd_ring_occupancy": [ctypes.c_int] * 6
    + [ctypes.c_void_p],
    "x3d_dw_conv3d_fwd_ring": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 23
    + epilogue.ARGTYPES,
}
_BWD_SIGNATURES = {
    "x3d_dw_conv3d_dk_parts": [ctypes.c_int] * 5,
    "x3d_dw_conv3d_dx": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 18
    + [ctypes.c_void_p],
    "x3d_dw_conv3d_dx_phase": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 18
    + [ctypes.c_void_p],
    "x3d_dw_conv3d_dk": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 18
    + [ctypes.c_void_p],
    "x3d_dw_conv3d_dk_ring": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 24
    + [ctypes.c_void_p],
}
_PBWD_SIGNATURES = {
    "x3d_dw_conv3d_pbwd_tiles": [ctypes.c_int] * 2,
    "x3d_dw_conv3d_pbwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
    + [ctypes.c_void_p],
    "x3d_dw_conv3d_pbwd_temporal_occupancy": [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    "x3d_dw_conv3d_pbwd_temporal": [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 13 + [ctypes.c_void_p],
}


def same_pads(in_size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF/XLA 'SAME' padding for one dimension: total pad split low/high
    with the extra element on the high side."""
    out_size = -(-in_size // stride)
    pad_total = max((out_size - 1) * stride + kernel - in_size, 0)
    lo = pad_total // 2
    return lo, pad_total - lo


def _resolve_pads(x_shape, kernel_shape, strides, padding) -> Pads:
    """Return explicit ((lo,hi),)*3 pads for the three spatiotemporal dims."""
    if padding == "SAME":
        return tuple(
            same_pads(x_shape[1 + i], kernel_shape[i], strides[i])
            for i in range(3))
    if padding == "VALID":
        return ((0, 0), (0, 0), (0, 0))
    return tuple(tuple(int(v) for v in p) for p in padding)


def _out_size(size: int, k: int, s: int, pad: Tuple[int, int]) -> int:
    return (size + pad[0] + pad[1] - k) // s + 1


# ------------------------------------------------------------------ costs
# A call's least work: each input read once and each output written once
# (the activations in their dtype, the taps float32 as the wrappers hand
# them over), a multiply-add two operations.


def _taps(kdims) -> int:
    return math.prod(int(k) for k in kdims)


def fwd_cost(x_shape, y_shape, kdims, elem: int) -> Tuple[int, int]:
    """K1's (bytes, flops): x read, y written, the taps read."""
    C, ny = x_shape[-1], math.prod(y_shape)
    return ((math.prod(x_shape) + ny) * elem + _taps(kdims) * C * 4,
            2 * _taps(kdims) * ny)


def bwd_cost(x_shape, g_shape, kdims, elem: int) -> Tuple[int, int]:
    """K4 dx's or dk's (bytes, flops), alike: dx reads the cotangent and
    the taps and writes dx; dk reads x and the cotangent and writes the
    taps' gradient."""
    C, ng = x_shape[-1], math.prod(g_shape)
    return ((math.prod(x_shape) + ng) * elem + _taps(kdims) * C * 4,
            2 * _taps(kdims) * ng)


def pbwd_cost(u_shape, kdims, elem: int) -> Tuple[int, int]:
    """K8's (bytes, flops): u and the cotangent read, du written, the taps
    read and their gradient written; both products over every output."""
    n, C = math.prod(u_shape), u_shape[-1]
    return 3 * n * elem + _taps(kdims) * C * 8, 4 * _taps(kdims) * n


def _log(kernel, body, x, kdims, direction, cost, bn="none") -> None:
    ops.log_launch(kernel, body, {"taps": [int(k) for k in kdims],
                                  "C": int(x.shape[-1])}, direction,
                   x.dtype, cost, bn)


def depthwise_conv3d_reference(x: torch.Tensor, kernel: torch.Tensor,
                               strides: Sequence[int], pads: Pads
                               ) -> torch.Tensor:
    """Plain version: explicit ``F.pad`` then ``F.conv3d(groups=C)``, in
    x's dtype.  x: (B, T, H, W, C); kernel: (kt, kh, kw, 1, C)."""
    C = x.shape[-1]
    (tlo, thi), (hlo, hhi), (wlo, whi) = pads
    xc = F.pad(x.permute(0, 4, 1, 2, 3), (wlo, whi, hlo, hhi, tlo, thi))
    w = kernel.permute(4, 3, 0, 1, 2).to(x.dtype)         # (C, 1, kt, kh, kw)
    y = F.conv3d(xc, w, stride=tuple(strides), groups=C)
    return y.permute(0, 2, 3, 4, 1).contiguous()


# ------------------------------------------------- K1's bodies and plans

TEMPORAL_THREADS = 256       # kTemporalThreads in depthwise.cu
CONV_RING_SMEM = 76 * 1024   # a ring-body block's most: three an SM


def fwd_body(kdims, strides, pads) -> str:
    """Which of K1's three bodies computes a call (pads explicit, none
    negative):

    * "temporal": spatial taps 1x1, strides (1, 1, 1), no spatial pads and
      1 <= kt <= RING_MAX_KT (the stem's k×1×1 conv);
    * "ring": spatial taps 3x3, temporal stride 1, spatial strides (s, s)
      with s 1 or 2, 1 <= kt <= RING_MAX_KT, a low temporal pad of at most
      kt - 1 and low pads of 0 or 1 in H and W (the stride-2 stage entries,
      at even planes (0, 1) and odd ones (1, 1));
    * "generic": every other geometry.
    """
    kt, kh, kw = (int(k) for k in kdims)
    st, sh, sw = (int(s) for s in strides)
    (tlo, thi), (hlo, hhi), (wlo, whi) = pads
    if min(tlo, thi, hlo, hhi, wlo, whi) >= 0 and 1 <= kt <= ring.RING_MAX_KT:
        if (kh, kw, st, sh, sw, hlo, hhi, wlo, whi) == (1, 1, 1, 1, 1, 0, 0,
                                                          0, 0):
            return "temporal"
        if ((kh, kw) == (3, 3) and st == 1 and sh == sw and sh in (1, 2)
                and tlo <= kt - 1 and hlo in (0, 1) and wlo in (0, 1)):
            return "ring"
    return "generic"


@functools.lru_cache(maxsize=None)
def temporal_plan(B: int, H: int, W: int, C: int, To: int, elem: int = 2,
                  align: int = 16, slots: int = 0) -> dict:
    """How the temporal body runs a call with To output frames: elements of
    ``elem`` bytes, x and y at addresses that are multiples of ``align``
    bytes, a card that holds ``slots`` threads at once (0: no runs are cut).

    * ``vec`` channels a cell: the widest cell of 16, 8, 4 bytes or one
      element that C and both addresses allow;
    * a thread for each (clip, pixel, cell) and run, TEMPORAL_THREADS a
      block;
    * runs of ``run`` frames: To is cut while the threads would not fill the
      card twice over, keeping runs of RING_MIN_RUN frames or more.
    """
    vec = next(v for v in (16 // elem, 8 // elem, 4 // elem, 1)
               if v >= 1 and C % v == 0 and align % (v * elem) == 0)
    cells = B * H * W * (C // vec)
    runs = 1
    while cells * runs < 2 * slots and -(-To // (runs + 1)) >= \
            ring.RING_MIN_RUN:
        runs += 1
    run = -(-To // runs)
    return dict(vec=vec, cell_bytes=vec * elem, run=run, runs=-(-To // run),
                threads=TEMPORAL_THREADS,
                blocks=-(-cells // TEMPORAL_THREADS))


def _conv_ring_smem(kt, stride, vec, elem, tile_h, row_cells, vec_pad, group,
                    rows) -> int:
    """Dynamic shared memory of a K1 ring-body block, as ``conv_ring_smem``
    in depthwise.cu lays it out: kt + RING_AHEAD slots of x, then the taps
    where they live there."""
    slot = ring.ring_slot(group // vec, vec, elem, tile_h, row_cells,
                          vec_pad, stride)
    return (-(-(kt + ring.RING_AHEAD) * slot // 16) * 16
            + ring.taps_smem(kt, vec, group))


@functools.lru_cache(maxsize=None)
def ring_plan(B: int, To: int, Ho: int, Wo: int, C: int, kt: int,
              stride: int = 1, elem: int = 2, align: int = 16,
              slots: int = 0) -> dict:
    """How K1's ring body runs a call with an output of (B, To, Ho, Wo, C)
    at spatial ``stride`` (x's address the one ``align`` counts), by
    ``ops/ring.plan``'s rules, as K2's ring body runs (``dw_fused.fwd_plan``):
    one role, one tile row a thread, a block of at most RING_MAX_THREADS
    threads and CONV_RING_SMEM bytes of shared memory (the ring's kt +
    RING_AHEAD slots of x, the taps where they do not fit in registers).
    At stride 2 a tile has at most RING_MAX_SIDE_2 pixels a side."""
    p = ring.plan(B, To, Ho, Wo, C, elem, align, slots,
                  ring.RING_MAX_THREADS, CONV_RING_SMEM,
                  lambda vec, *rest: _conv_ring_smem(kt, stride, vec, elem,
                                                     *rest),
                  row_a_thread=True, stride=stride)
    p["threads"] = 32 * p.pop("warps")
    del p["parts"]
    return p


def _launch_fwd(lib, body, x, taps, kdims, strides, pads, stream,
                bn=epilogue.NO_POINTERS):
    """K1's ``body`` on x (contiguous, on a CUDA device) and prepared taps
    ((kt * kh * kw, C) float32, rounded to x's dtype), with the epilogue's
    (mul, add, relu) arguments ``bn`` (``epilogue.pointers``); returns y or
    raises."""
    B, T, H, W, C = x.shape
    kt, kh, kw = kdims
    out = [_out_size(n, k, s, p) for n, k, s, p in
           zip((T, H, W), kdims, strides, pads)]
    y = torch.empty((B, *out, C), dtype=x.dtype, device=x.device)
    code = kernels.dtype_code(x)
    args = (x.data_ptr(), taps.data_ptr(), y.data_ptr(), code, B, T, H, W, C,
            kt)
    if body == "temporal":
        p = _temporal_plan(lib, x, y, kt, out[0])
        rc = lib.x3d_dw_conv3d_fwd_temporal(*args, pads[0][0], out[0],
                                            p["vec"], p["run"], *bn, stream)
    elif body == "ring":
        p = _ring_plan(lib, x, kt, strides[1], out)
        rc = lib.x3d_dw_conv3d_fwd_ring(
            *args, strides[1], pads[0][0], pads[1][0], pads[2][0], *out,
            p["tile_h"], p["tile_w"], p["group"], p["vec"], p["rows"],
            p["run"], p["granule"], p["row_cells"], p["vec_pad"], *bn,
            stream)
    else:
        rc = lib.x3d_dw_conv3d_fwd(*args, kh, kw, *strides, pads[0][0],
                                   pads[1][0], pads[2][0], *out, *bn, stream)
    kernels.raise_on_error(rc, f"depthwise_conv3d ({body} body) kernel "
                           "launch")
    return y


def _temporal_plan(lib, x, y, kt: int, To: int) -> dict:
    """:func:`temporal_plan` for a call on x and y and this card (its
    threads at once from the library's occupancy query)."""
    B, T, H, W, C = x.shape
    args = (B, H, W, C, To, x.element_size(), ring.align(x, y))
    p = temporal_plan(*args)
    blocks = ring.card_slots(lib, "x3d_dw_conv3d_fwd_temporal_occupancy",
                             kernels.dtype_code(x), p["vec"], kt)
    return temporal_plan(*args, slots=blocks * TEMPORAL_THREADS)


def _ring_plan(lib, x, kt: int, stride: int, out) -> dict:
    """:func:`ring_plan` for a call on x and this card (its blocks at once
    from the library's occupancy query)."""
    B, C = x.shape[0], x.shape[-1]
    args = (B, *out, C, kt, stride, x.element_size(), ring.align(x))
    p = ring_plan(*args)
    return ring_plan(*args, slots=ring.card_slots(
        lib, "x3d_dw_conv3d_fwd_ring_occupancy", kernels.dtype_code(x),
        p["vec"], kt, stride, p["threads"], p["smem_bytes"]))


def depthwise_conv3d(x: torch.Tensor, kernel: torch.Tensor,
                     strides: Sequence[int] = (1, 1, 1),
                     padding="SAME", mul=None, add=None,
                     relu: bool = False) -> torch.Tensor:
    """Depthwise 3-D conv: (B, T, H, W, C) -> (B, To, Ho, Wo, C) in x's dtype.

    ``kernel`` (kt, kh, kw, 1, C) is rounded to x's dtype, as the JAX op
    casts it; the kernel sums taps in float32.  ``padding``: "SAME",
    "VALID" or explicit ((lo, hi),)*3.  ``mul``, ``add``: (C,) float32, an
    eval BatchNorm applied to y as it is stored, and ``relu`` a ReLU after
    it (``ops/epilogue.py``).  A CPU tensor takes the plain version; a
    CUDA tensor launches K1's body that :func:`fwd_body` names (float32 or
    bfloat16), or raises.
    """
    if x.dim() != 5 or kernel.dim() != 5 or kernel.shape[3] != 1 \
            or kernel.shape[4] != x.shape[4]:
        raise ValueError(
            f"expected x (B,T,H,W,C) and taps (kt,kh,kw,1,C), got "
            f"{tuple(x.shape)} and {tuple(kernel.shape)}")
    strides = tuple(int(s) for s in strides)
    pads = _resolve_pads(x.shape, kernel.shape[:3], strides, padding)
    kdims = tuple(int(k) for k in kernel.shape[:3])
    epilogue.check(mul, add, relu, x.shape[-1])
    bn = epilogue.kind(mul, relu)
    if x.device.type == "cpu":
        body = "plain"
        y = epilogue.reference(
            depthwise_conv3d_reference(x, kernel, strides, pads), mul, add,
            relu)
    else:
        kernels.check_cuda(x)
        taps = kernel.to(x.dtype).to(torch.float32).reshape(-1, x.shape[-1])
        taps = taps.contiguous()
        coefs = epilogue.prepare(mul, add, x)
        kernels.check_cuda(x, taps, *(coefs or ()))
        body = fwd_body(kdims, strides, pads)
        lib = epilogue.library("depthwise.cu", _SIGNATURES, coefs)
        y = _launch_fwd(lib, body, x, taps, kdims, strides, pads,
                        kernels.stream_handle(x),
                        epilogue.pointers(coefs, relu))
        depthwise_conv3d.launches += 1
        depthwise_conv3d.body_launches[body] += 1
        if coefs is not None:
            depthwise_conv3d.epilogue_launches[bn] += 1
    if ops.records is not None:
        _log("K1", body, x, kdims, "fwd", epilogue.cost(
            bn, x.shape[-1], y.numel(),
            fwd_cost(x.shape, y.shape, kdims, x.element_size())), bn)
    return y


depthwise_conv3d.launches = 0
depthwise_conv3d.body_launches = {"temporal": 0, "ring": 0, "generic": 0}
depthwise_conv3d.epilogue_launches = epilogue.counter()


# ------------------------------------------------------------ K4: backward


def _check_pads(pads: Pads) -> Pads:
    return tuple(tuple(int(v) for v in p) for p in pads)


def _padded_nchw(x: torch.Tensor, pads: Pads) -> torch.Tensor:
    (tlo, thi), (hlo, hhi), (wlo, whi) = pads
    return F.pad(x.permute(0, 4, 1, 2, 3), (wlo, whi, hlo, hhi, tlo, thi))


def depthwise_conv3d_dx_reference(g: torch.Tensor, kernel: torch.Tensor,
                                  x_shape, strides: Sequence[int], pads: Pads
                                  ) -> torch.Tensor:
    """Plain version of K4's dx: the gradient of the conv with respect to
    its input, summed in float32 and rounded to g's dtype.  g: (B, To, Ho,
    Wo, C); kernel: (kt, kh, kw, 1, C) in g's dtype; x_shape: (B, T, H, W, C)."""
    B, T, H, W, C = x_shape
    (tlo, thi), (hlo, hhi), (wlo, whi) = pads
    w = kernel.permute(4, 3, 0, 1, 2).to(torch.float32)
    dxp = torch.nn.grad.conv3d_input(
        (B, C, T + tlo + thi, H + hlo + hhi, W + wlo + whi), w,
        g.permute(0, 4, 1, 2, 3).to(torch.float32), stride=tuple(strides),
        groups=C)
    dx = dxp[:, :, tlo:tlo + T, hlo:hlo + H, wlo:wlo + W]
    return dx.permute(0, 2, 3, 4, 1).to(g.dtype).contiguous()


def depthwise_conv3d_dk_reference(x: torch.Tensor, g: torch.Tensor, kdims,
                                  strides: Sequence[int], pads: Pads
                                  ) -> torch.Tensor:
    """Plain version of K4's dk: the gradient of the conv with respect to
    its taps, in float32, shaped (kt, kh, kw, 1, C)."""
    C = x.shape[-1]
    dk = torch.nn.grad.conv3d_weight(
        _padded_nchw(x.to(torch.float32), pads), (C, 1, *kdims),
        g.permute(0, 4, 1, 2, 3).to(torch.float32), stride=tuple(strides),
        groups=C)
    return dk.permute(2, 3, 4, 1, 0).contiguous()


def _bwd_geometry(x_shape, g: torch.Tensor, kdims, strides, pads):
    B, T, H, W, C = x_shape
    out = [_out_size(n, k, s, p) for n, k, s, p in
           zip((T, H, W), kdims, strides, pads)]
    if tuple(g.shape) != (B, *out, C):
        raise ValueError(f"gradient of shape {tuple(g.shape)} does not match "
                         f"the conv's output {(B, *out, C)}")
    return (B, T, H, W, C, *kdims, *strides, pads[0][0], pads[1][0],
            pads[2][0], *out)


PHASE_MAX_KT = 5      # kPhaseMaxKt in depthwise_bwd.cu


def dx_body(kdims, strides, pads) -> str:
    """Which of K4's two dx bodies computes a call: "phase" for spatial taps
    3x3 at spatial stride 2, temporal stride 1, 1 <= kt <= PHASE_MAX_KT and
    low-side pads of 0 or 1 in H and W (the stride-2 stage entries, at even
    planes (0, 1) and odd ones (1, 1)); "gather" for every other geometry."""
    kt, kh, kw = (int(k) for k in kdims)
    if ((kh, kw) == (3, 3) and tuple(int(s) for s in strides) == (1, 2, 2)
            and 1 <= kt <= PHASE_MAX_KT
            and pads[1][0] in (0, 1) and pads[2][0] in (0, 1)):
        return "phase"
    return "gather"


def depthwise_conv3d_dx(g: torch.Tensor, kernel: torch.Tensor, x_shape,
                        strides: Sequence[int], pads: Pads) -> torch.Tensor:
    """dx of :func:`depthwise_conv3d` (kernel K4): (B, T, H, W, C) in g's
    dtype, taps summed in float32.  ``kernel`` (kt, kh, kw, 1, C) is
    rounded to g's dtype; ``pads`` are explicit ((lo, hi),)*3.  A CPU tensor
    takes the plain version; a CUDA tensor launches K4's body that
    :func:`dx_body` names, or raises."""
    strides, pads = tuple(int(s) for s in strides), _check_pads(pads)
    kdims = tuple(kernel.shape[:3])
    dims = _bwd_geometry(x_shape, g, kdims, strides, pads)
    k = kernel.to(g.dtype)
    if g.device.type == "cpu":
        body = "plain"
        dx = depthwise_conv3d_dx_reference(g, k, x_shape, strides, pads)
    else:
        kernels.check_cuda(g)
        taps = k.to(torch.float32).reshape(-1, x_shape[-1]).contiguous()
        dx = torch.empty(tuple(x_shape), dtype=g.dtype, device=g.device)
        kernels.check_cuda(g, taps, dx)
        lib = _build.load("depthwise_bwd.cu", _BWD_SIGNATURES)
        body = dx_body(kdims, strides, pads)
        launch = lib.x3d_dw_conv3d_dx_phase if body == "phase" \
            else lib.x3d_dw_conv3d_dx
        rc = launch(g.data_ptr(), taps.data_ptr(), dx.data_ptr(),
                    kernels.dtype_code(g), *dims, kernels.stream_handle(g))
        kernels.raise_on_error(rc, f"depthwise_conv3d_dx ({body} body) "
                               "kernel launch")
        depthwise_conv3d_dx.launches += 1
        depthwise_conv3d_dx.body_launches[body] += 1
    if ops.records is not None:
        _log("K4 dx", body, g, kdims, "bwd",
             bwd_cost(x_shape, g.shape, kdims, g.element_size()))
    return dx


def dk_body(kdims, strides, pads) -> str:
    """Which of K4's two dk bodies computes a call: "ring" under exactly
    K1's ring-body conditions (:func:`fwd_body`: spatial taps 3x3, temporal
    stride 1, spatial strides (s, s) with s 1 or 2, 1 <= kt <= RING_MAX_KT,
    a low temporal pad of at most kt - 1, low pads of 0 or 1 in H and W --
    the stride-2 stage entries, at even and odd planes); "generic" for
    every other geometry."""
    return "ring" if fwd_body(kdims, strides, pads) == "ring" else "generic"


def _dk_ring_smem(kt, stride, vec, elem, tile_h, row_cells, vec_pad, group,
                  rows) -> int:
    """Dynamic shared memory of a K4 dk ring-body block, as ``dk_ring_smem``
    in depthwise_bwd.cu lays it out: kt + RING_AHEAD slots of x (K1's
    ring), whose bytes the thread rows' kt * 9 dk sums a channel reuse after
    the frames."""
    slot = ring.ring_slot(group // vec, vec, elem, tile_h, row_cells,
                          vec_pad, stride)
    red = rows * 9 * kt * group * 4
    return -(-max((kt + ring.RING_AHEAD) * slot, red) // 16) * 16


@functools.lru_cache(maxsize=None)
def dk_ring_plan(B: int, To: int, Ho: int, Wo: int, C: int, kt: int,
                 stride: int = 1, elem: int = 2, align: int = 16) -> dict:
    """How K4 dk's ring body runs a call whose cotangent is (B, To, Ho, Wo,
    C) at spatial ``stride`` (x's address the one ``align`` counts), by
    ``ops/ring.plan``'s rules, as K1's ring body runs the forward
    (:func:`ring_plan`): one tile row a thread, a block of at most
    RING_MAX_THREADS threads and CONV_RING_SMEM bytes of shared memory (the
    ring's kt + RING_AHEAD slots of x, or the rows' sums after the frames if
    they take more).  At stride 2 a tile has at most RING_MAX_SIDE_2 pixels
    a side.

    The run rule: one run, a block walks all To frames.  Cutting them into
    runs to fill the card, as K1's plan does, measured slower at every X3D
    stage entry (each run rereads kt - 1 planes and adds a partial; PERF.md
    §6).  Each block writes one float32 partial per (tap, channel) of
    its group: ``partials`` = clips x tiles x runs x groups blocks, into
    ``parts`` = clips x tiles x runs rows of a (parts, taps, C) buffer,
    which the second pass sums in a fixed order."""
    p = ring.plan(B, To, Ho, Wo, C, elem, align, 0,
                  ring.RING_MAX_THREADS, CONV_RING_SMEM,
                  lambda vec, *rest: _dk_ring_smem(kt, stride, vec, elem,
                                                   *rest),
                  row_a_thread=True, stride=stride)
    p["threads"] = 32 * p.pop("warps")
    p["partials"] = p["parts"] * p["groups"]
    return p


def _dk_ring_plan(x, kt: int, stride: int, out) -> dict:
    """:func:`dk_ring_plan` for a call on x."""
    return dk_ring_plan(x.shape[0], *out, x.shape[-1], kt, stride,
                        x.element_size(), ring.align(x))


def _launch_dk(lib, body, x, g, kdims, strides, pads, stream):
    """K4 dk's ``body`` on x and g (contiguous, one dtype, on a CUDA device,
    g of the conv's output shape); returns dk as (taps, C) float32 or
    raises."""
    dims = _bwd_geometry(x.shape, g, kdims, strides, pads)
    B, C = x.shape[0], x.shape[-1]
    ntaps = math.prod(kdims)
    dk = torch.empty((ntaps, C), dtype=torch.float32, device=x.device)
    if body == "ring":
        p = _dk_ring_plan(x, kdims[0], strides[1], dims[-3:])
        parts = p["parts"]
    else:
        parts = lib.x3d_dw_conv3d_dk_parts(B, *dims[-2:], *strides[1:])
    part = torch.empty((parts, ntaps, C), dtype=torch.float32,
                       device=x.device)
    ptrs = (x.data_ptr(), g.data_ptr(), part.data_ptr(), dk.data_ptr(),
            kernels.dtype_code(x))
    if body == "ring":
        rc = lib.x3d_dw_conv3d_dk_ring(
            *ptrs, *dims[:6], strides[1], *(lo for lo, _ in pads),
            *dims[-3:], parts, p["tile_h"], p["tile_w"], p["group"],
            p["vec"], p["rows"], p["run"], p["granule"], p["row_cells"],
            p["vec_pad"], stream)
    else:
        rc = lib.x3d_dw_conv3d_dk(*ptrs, *dims, stream)
    kernels.raise_on_error(rc, f"depthwise_conv3d_dk ({body} body) kernel "
                           "launch")
    return dk


def depthwise_conv3d_dk(x: torch.Tensor, g: torch.Tensor, kdims,
                        strides: Sequence[int], pads: Pads) -> torch.Tensor:
    """dk of :func:`depthwise_conv3d` (kernel K4): (kt, kh, kw, 1, C)
    float32, from per-block partials summed in a fixed order.  x and g share
    a dtype.  A CPU tensor takes the plain version; a CUDA tensor launches
    K4's body that :func:`dk_body` names, or raises."""
    strides, pads = tuple(int(s) for s in strides), _check_pads(pads)
    kdims = tuple(int(k) for k in kdims)
    _bwd_geometry(x.shape, g, kdims, strides, pads)
    if g.dtype != x.dtype:
        raise TypeError(f"x is {x.dtype} but its gradient {g.dtype}")
    if x.device.type == "cpu":
        body = "plain"
        dk = depthwise_conv3d_dk_reference(x, g, kdims, strides, pads)
    else:
        kernels.check_cuda(x, g)
        lib = _build.load("depthwise_bwd.cu", _BWD_SIGNATURES)
        body = dk_body(kdims, strides, pads)
        dk = _launch_dk(lib, body, x, g, kdims, strides, pads,
                        kernels.stream_handle(x))
        depthwise_conv3d_dk.launches += 1
        depthwise_conv3d_dk.body_launches[body] += 1
    if ops.records is not None:
        _log("K4 dk", body, x, kdims, "bwd",
             bwd_cost(x.shape, g.shape, kdims, x.element_size()))
    return dk.reshape(*kdims, 1, x.shape[-1])


depthwise_conv3d_dx.launches = 0
depthwise_conv3d_dx.body_launches = {"phase": 0, "gather": 0}
depthwise_conv3d_dk.launches = 0
depthwise_conv3d_dk.body_launches = {"ring": 0, "generic": 0}


# ------------------------------------------------ K8: one-pass backward


def pbwd_eligible(x_shape, kdims, strides, pads) -> bool:
    """Whether a conv's backward can run as K8: stride (1, 1, 1), SAME pads,
    odd taps, and at least as many frames as temporal taps (the conditions
    of the JAX package's ``impl="pbwd"``, without its lane clause)."""
    same = tuple(same_pads(x_shape[1 + i], kdims[i], 1) for i in range(3))
    return (tuple(strides) == (1, 1, 1)
            and tuple(tuple(p) for p in pads) == same
            and all(k % 2 == 1 for k in kdims)
            and x_shape[1] >= kdims[0])


def _pbwd_check(u, gy, kernel):
    if u.dim() != 5 or kernel.dim() != 5 or kernel.shape[3] != 1 \
            or kernel.shape[4] != u.shape[4]:
        raise ValueError(
            f"expected u (B,T,H,W,C) and taps (kt,kh,kw,1,C), got "
            f"{tuple(u.shape)} and {tuple(kernel.shape)}")
    if tuple(gy.shape) != tuple(u.shape):
        raise ValueError(f"the cotangent {tuple(gy.shape)} must have u's "
                         f"shape {tuple(u.shape)}")
    if gy.dtype != u.dtype:
        raise TypeError(f"u is {u.dtype} but its cotangent {gy.dtype}")
    kdims = tuple(int(k) for k in kernel.shape[:3])
    pads = tuple(same_pads(u.shape[1 + i], kdims[i], 1) for i in range(3))
    if not pbwd_eligible(u.shape, kdims, (1, 1, 1), pads):
        raise ValueError(f"the one-pass backward takes odd taps and at "
                         f"least kt frames, got taps {kdims} on "
                         f"{tuple(u.shape)}")
    return kdims, pads


def depthwise_conv3d_pbwd_reference(u: torch.Tensor, gy: torch.Tensor,
                                    kernel: torch.Tensor):
    """Plain version of K8: K4's two plain versions, one after the other."""
    kdims, pads = _pbwd_check(u, gy, kernel)
    k = kernel.to(u.dtype)
    return (depthwise_conv3d_dx_reference(gy, k, u.shape, (1, 1, 1), pads),
            depthwise_conv3d_dk_reference(u, gy, kdims, (1, 1, 1), pads))


PBWD_THREADS = 256     # kPbwdThreads in depthwise_pbwd.cu
PBWD_MAX_CELL = 8      # kPbwdMaxCell: the widest cell in bytes
PBWD_MAX_PARTS = 512   # partials past which a block walks more pixel rows


def pbwd_body(kdims, pads) -> str:
    """Which of K8's two bodies computes a call (one that
    :func:`pbwd_eligible` admits): "temporal" for spatial taps 1x1, odd
    1 <= kt <= RING_MAX_KT and SAME pads ((kt // 2,) * 2 in time, none in
    space) -- the stem's k×1×1 conv; "generic" for every other geometry."""
    kt, kh, kw = (int(k) for k in kdims)
    lo = kt // 2
    if ((kh, kw) == (1, 1) and kt % 2 == 1 and 1 <= kt <= ring.RING_MAX_KT
            and tuple(tuple(int(v) for v in p) for p in pads)
            == ((lo, lo), (0, 0), (0, 0))):
        return "temporal"
    return "generic"


@functools.lru_cache(maxsize=None)
def pbwd_temporal_plan(B: int, T: int, H: int, W: int, C: int, kt: int,
                       elem: int = 2, align: int = 16,
                       slots: int = 0) -> dict:
    """How K8's temporal body runs a call on (B, T, H, W, C) with kt taps:
    elements of ``elem`` bytes, u, gy and du at addresses that are
    multiples of ``align`` bytes, a card that holds ``slots`` threads at
    once (0: no runs are cut).

    * ``vec`` channels a cell: the widest cell of PBWD_MAX_CELL or 4 bytes
      or one element that C and the addresses allow (16-byte cells measured
      slower at the X3D stems, PERF.md §6);
    * a block of ``threads`` = ``group`` x ``pixels`` threads (cell, pixel):
      ``group`` cells of one channel group (all C / vec where they fit in
      PBWD_THREADS, else ``groups`` equal groups) by ``pixels`` rows;
    * runs of ``run`` frames: T is cut while a thread a cell would not fill
      the card twice over, keeping runs of RING_MIN_RUN frames or more (the
      rule of :func:`temporal_plan`; each cut rereads kt - 1 frames);
    * a block takes ``walk`` pixel rows one after another, the fewest that
      keep the partials at PBWD_MAX_PARTS or under (a partial a block cost
      the second pass 9% of the kernel at X3D-M; walking cost the kernel
      nothing, PERF.md §6); ``pblocks`` blocks along the pixels,
      ``blocks`` = pblocks x runs x groups in all;
    * ``parts`` = pblocks x runs rows of the (parts, kt, C) float32
      partials, one a block and channel group, which the second pass sums in
      a fixed order; ``smem_bytes`` the block's kt x vec sums a thread.
    """
    vec = next(v for v in (PBWD_MAX_CELL // elem, 4 // elem, 1)
               if v >= 1 and C % v == 0 and align % (v * elem) == 0)
    cells = C // vec
    groups = -(-cells // PBWD_THREADS)
    group = -(-cells // groups)
    pixels = PBWD_THREADS // group
    N = B * H * W
    runs = 1
    while N * cells * runs < 2 * slots and -(-T // (runs + 1)) >= \
            ring.RING_MIN_RUN:
        runs += 1
    run = -(-T // runs)
    runs = -(-T // run)
    rows = -(-N // pixels)
    walk = max(1, -(-rows * runs // PBWD_MAX_PARTS))
    pblocks = -(-rows // walk)
    return dict(vec=vec, cell_bytes=vec * elem, group=group, groups=groups,
                pixels=pixels, threads=group * pixels, walk=walk, run=run,
                runs=runs, pblocks=pblocks, blocks=pblocks * runs * groups,
                parts=pblocks * runs,
                smem_bytes=group * pixels * kt * vec * 4)


def _pbwd_temporal_plan(lib, u, gy, du, kt: int) -> dict:
    """:func:`pbwd_temporal_plan` for a call on u, gy, du and this card (its
    threads at once from the library's occupancy query)."""
    args = (*u.shape, kt, u.element_size(), ring.align(u, gy, du))
    p = pbwd_temporal_plan(*args)
    blocks = ring.card_slots(lib, "x3d_dw_conv3d_pbwd_temporal_occupancy",
                             kernels.dtype_code(u), p["vec"], kt,
                             p["threads"], p["smem_bytes"])
    return pbwd_temporal_plan(*args, slots=blocks * p["threads"])


def _launch_pbwd(lib, body, u, gy, taps, kdims, stream):
    """K8's ``body`` on u and gy (contiguous, one dtype, on a CUDA device)
    and prepared taps ((kt * kh * kw, C) float32, rounded to u's dtype);
    returns du and dk as (taps, C) float32, or raises."""
    B, T, H, W, C = u.shape
    ntaps = math.prod(kdims)
    du = torch.empty_like(u)
    dk = torch.empty((ntaps, C), dtype=torch.float32, device=u.device)
    if body == "temporal":
        p = _pbwd_temporal_plan(lib, u, gy, du, kdims[0])
        parts = p["parts"]
    else:
        parts = B * lib.x3d_dw_conv3d_pbwd_tiles(H, W)
    part = torch.empty((parts, ntaps, C), dtype=torch.float32,
                       device=u.device)
    ptrs = (u.data_ptr(), gy.data_ptr(), taps.data_ptr(), du.data_ptr(),
            part.data_ptr(), dk.data_ptr(), kernels.dtype_code(u), B, T, H, W,
            C)
    if body == "temporal":
        rc = lib.x3d_dw_conv3d_pbwd_temporal(
            *ptrs, kdims[0], p["vec"], p["group"], p["pixels"], p["walk"],
            p["run"], parts, stream)
    else:
        rc = lib.x3d_dw_conv3d_pbwd(*ptrs, *kdims, stream)
    kernels.raise_on_error(rc, f"depthwise_conv3d_pbwd ({body} body) kernel "
                           "launch")
    return du, dk


def depthwise_conv3d_pbwd(u: torch.Tensor, gy: torch.Tensor,
                          kernel: torch.Tensor):
    """Both gradients of a stride-1 SAME odd-tap depthwise conv in one pass
    over (u, gy) (kernel K8).

    Args:
      u: (B, T, H, W, C) the conv's input, float32 or bfloat16.
      gy: the cotangent of its output, u's shape and dtype.
      kernel: (kt, kh, kw, 1, C) taps, rounded to u's dtype.

    Returns:
      du (B, T, H, W, C) in u's dtype, taps summed in float32; dk (kt, kh,
      kw, 1, C) float32, from per-block partials summed in a fixed order.

    A CPU tensor takes the plain version; a CUDA tensor launches K8's body
    that :func:`pbwd_body` names, or raises.
    """
    kdims, pads = _pbwd_check(u, gy, kernel)
    C = u.shape[-1]
    if u.device.type == "cpu":
        body = "plain"
        du, dk = depthwise_conv3d_pbwd_reference(u, gy, kernel)
    else:
        kernels.check_cuda(u, gy)
        taps = kernel.to(u.dtype).to(torch.float32).reshape(-1, C)
        taps = taps.contiguous()
        kernels.check_cuda(u, gy, taps)
        body = pbwd_body(kdims, pads)
        lib = _build.load("depthwise_pbwd.cu", _PBWD_SIGNATURES)
        du, dk = _launch_pbwd(lib, body, u, gy, taps, kdims,
                              kernels.stream_handle(u))
        depthwise_conv3d_pbwd.launches += 1
        depthwise_conv3d_pbwd.body_launches[body] += 1
    if ops.records is not None:
        _log("K8", body, u, kdims, "bwd",
             pbwd_cost(u.shape, kdims, u.element_size()))
    return du, dk.reshape(*kdims, 1, C)


depthwise_conv3d_pbwd.launches = 0
depthwise_conv3d_pbwd.body_launches = {"temporal": 0, "generic": 0}


class _Depthwise(torch.autograd.Function):
    """K1 forward; backward K8 (both gradients wanted, stride 1, SAME, odd
    taps) or K4; within ``ops.plain_versions()`` all run their plain
    versions.  Where ``ops.via_library()`` holds (export, a remat "convs"
    region) the forward is the op ``x3d::depthwise_conv3d``
    (``ops/library.py``)."""

    @staticmethod
    def forward(ctx, x, kernel, strides, pads):
        k = kernel.to(x.dtype)
        ctx.save_for_backward(x, k)
        ctx.conf = (strides, pads, kernel.dtype)
        if ops.plain_versions_enabled():
            return depthwise_conv3d_reference(x, k, strides, pads)
        if ops.via_library():
            from x3d_tpu_torch.ops import library
            return library.depthwise_conv3d(x, k, strides,
                                            [v for p in pads for v in p])
        return depthwise_conv3d(x, k, strides, pads)

    @staticmethod
    def backward(ctx, g):
        x, k = ctx.saved_tensors
        strides, pads, kernel_dtype = ctx.conf
        g = g.contiguous()
        plain = ops.plain_versions_enabled()
        if all(ctx.needs_input_grad[:2]) \
                and pbwd_eligible(x.shape, k.shape[:3], strides, pads):
            dx, dk = (depthwise_conv3d_pbwd_reference if plain
                      else depthwise_conv3d_pbwd)(x, g, k)
            return dx, dk.to(kernel_dtype), None, None
        dx = dk = None
        if ctx.needs_input_grad[0]:
            dx = (depthwise_conv3d_dx_reference if plain
                  else depthwise_conv3d_dx)(g, k, x.shape, strides, pads)
        if ctx.needs_input_grad[1]:
            dk = (depthwise_conv3d_dk_reference if plain
                  else depthwise_conv3d_dk)(x, g, k.shape[:3], strides, pads)
            dk = dk.to(kernel_dtype)
        return dx, dk, None, None


def depthwise(x: torch.Tensor, kernel: torch.Tensor,
              strides: Sequence[int] = (1, 1, 1), padding="SAME", mul=None,
              add=None, relu: bool = False) -> torch.Tensor:
    """The differentiable depthwise conv: (B, T, H, W, C) -> (B, To, Ho, Wo,
    C) in x's dtype, with gradients for x and for the (kt, kh, kw, 1, C)
    taps (float32 parameters, rounded to x's dtype for the product).
    ``mul``, ``add`` and ``relu``: an eval BatchNorm after the conv
    (``ops/epilogue.py``; forward only), K1's epilogue where K1 runs, else
    the plain version after the conv."""
    strides = tuple(int(s) for s in strides)
    pads = _resolve_pads(x.shape, kernel.shape[:3], strides, padding)
    if mul is None:
        return _Depthwise.apply(x.contiguous(), kernel, strides, pads)
    epilogue.forward_only(mul, x, kernel, add)
    k = kernel.to(x.dtype)
    if ops.plain_versions_enabled():
        return epilogue.reference(
            depthwise_conv3d_reference(x, k, strides, pads), mul, add, relu)
    if ops.via_library():
        from x3d_tpu_torch.ops import library
        return library.depthwise_conv3d(
            x.contiguous(), k, strides, [v for p in pads for v in p], mul,
            add, relu)
    return depthwise_conv3d(x.contiguous(), k, strides, pads, mul, add, relu)


def depthwise_conv3d_folded(x: torch.Tensor, kernel: torch.Tensor,
                            fold_T: int, strides: Sequence[int] = (1, 1, 1),
                            padding="SAME") -> torch.Tensor:
    """The depthwise conv on a time-folded (B·T, 1, H, W, C) input, the
    JAX package's ``depthwise_conv3d_folded``
    (``x3d_tpu/ops/depthwise.py:189-265``), with its checks: temporal
    stride 1, a folded input, SAME temporal pads (or k // 2 each side).

    The folded tensor is the same memory as the NDHWC (B, T, H, W, C) one,
    so the conv runs on that view (:func:`depthwise`: K1 on a CUDA tensor,
    its plain version on the CPU, differentiable) and its output is viewed
    as (B·T, 1, Ho, Wo, C) again: no copy and no kernel of its own.
    ``kernel`` (kt, kh, kw, 1, C) is the unfolded conv's parameter;
    ``padding`` "SAME" or explicit pads over the logical (T, H, W)."""
    kt = kernel.shape[0]
    T, N = fold_T, x.shape[0]
    if strides[0] != 1:
        raise ValueError("folded depthwise requires temporal stride 1")
    if x.dim() != 5 or x.shape[1] != 1 or N % T:
        raise ValueError(f"expected folded (B*{T},1,H,W,C) input, "
                         f"got {tuple(x.shape)}")
    logical = x.view(N // T, T, *x.shape[2:])
    pads = _resolve_pads(logical.shape, kernel.shape[:3], strides, padding)
    if pads[0] != same_pads(T, kt, 1) and pads[0] != (kt // 2, kt // 2):
        raise ValueError(f"unsupported temporal padding {pads[0]}")
    y = depthwise(logical, kernel, strides, pads)
    return y.view(N, 1, *y.shape[2:])
