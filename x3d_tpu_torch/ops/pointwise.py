"""Pointwise (1x1x1) conv on NDHWC activations.

With C contiguous a 1x1x1 conv is a ``(B*T*H*W, Cin) @ (Cin, Cout)``
product.  Weights are ``(Cout, Cin)``.

* :func:`pointwise_conv3d` is the differentiable op the model calls.  A
  bulk conv -- a 5-D input with more than one position and no bias
  (:func:`routes_to_kernel`) -- goes to the hand-written CUDA kernel K7
  (``kernels/csrc/pointwise.cu``), which replaces the TPU kernel
  ``pw_batchminor._pw_kernel``; its backward's dx is K7 again on the
  cotangent and the transposed weight, its dk the float32 contraction
  ``x^T g`` left to ``torch.matmul`` (as the JAX package leaves it to XLA).
  The Squeeze-Excite and head layers (one position, or a bias) stay
  ``F.linear``, as the JAX package leaves them to XLA.
* :func:`pw_conv` is K7's wrapper; :func:`pointwise_conv3d_reference` is
  the plain PyTorch version (``F.linear``).  K7 has three bodies, one per
  call by :func:`pw_body` (none falls back to another; counted in
  ``pw_conv.body_launches``): "wg" (bfloat16 on wgmma and TMA,
  ``pw_wgmma.cuh``, laid out by :func:`wg_plan`), "pipe" (bfloat16 on
  ``pw_gemm.cuh``'s ``pipe_gemm``, which K5 and K6 run too) and
  "cuda_core" (float32 without TF32, and what neither tensor-core body
  takes).  :func:`_launch` runs any body on the same inputs.
  :func:`cost` gives a call's least bytes and operations, which the
  wrapper writes into an open ``ops.launch_log``.
* Each body may apply an eval BatchNorm, and a ReLU, to y as it stores it
  (``mul``, ``add``, ``relu``: ``ops/epilogue.py``), which the model passes
  for the BatchNorm after conv ``c``, after conv ``a`` at the stage
  entries, after the projections and after conv_5.

A strided projection reads every s-th row and column (a 1x1x1 kernel with
stride s is a subsample); K7 reads them in place.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from x3d_tpu_torch import kernels, ops
from x3d_tpu_torch.kernels import _build
from x3d_tpu_torch.ops import epilogue, ring

_SIGNATURES = {
    "x3d_pw_conv": [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong]
    + [ctypes.c_int] * 7 + epilogue.ARGTYPES,
    "x3d_pw_conv_wg": [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
    + [ctypes.c_int] * 13 + epilogue.ARGTYPES,
    "x3d_pw_conv_wg_smem": [ctypes.c_int] * 5,
    "x3d_pw_conv_plan": [ctypes.c_int] * 2 + [ctypes.c_void_p],
}

# The wg body's layout (pw_wgmma.cuh; change both): the column tiles a call
# may take (the instantiations of wgmma's N), 64 rows a consumer warpgroup,
# 64 k a ring stage (a 128-byte swizzle row), at most 12 stages, a 1 KB
# head of mbarriers and 1 KB of slack to align the tiles, two y buffers a
# consumer warpgroup; the card's 227 KB of shared memory a block.
WG_COLUMNS = (24, 48, 56, 96, 112, 144, 192, 216, 256)
WG_ROWS = 64
WG_BK = 64
WG_MAX_STAGES = 12
WG_HEAD = WG_ALIGN = 1024
WG_OUT_BUFS = 2
MAX_SMEM = 227 * 1024
# The plan's choices: W stays in shared memory where its slice takes at
# most WG_RESIDENT_PER_TILE bytes for each row tile a block walks (it must
# arrive whole before the first product), at most WG_RESIDENT_MAX, beside
# a ring of WG_MIN_STAGES stages, or of a row tile's k-tiles if fewer; two
# consumer warpgroups (128-row tiles) where their ring keeps as many
# (measured: stage 4's conv a, two k-tiles, runs faster on two stages of
# 128 rows than on twelve of 64); two blocks an SM where column tiles
# are at most WG_TWO_BLOCKS_BN wide (and their ring keeps WG_MIN_STAGES in
# half the SM's shared memory); N wider than one column tile cut into tiles
# of at most WG_SPLIT_BN; column tiles cut narrower, down to WG_MIN_SPLIT
# columns, while the grid has fewer blocks than SMs.
WG_RESIDENT_MAX = 96 * 1024
WG_RESIDENT_PER_TILE = 24 * 1024
WG_SPLIT_BN = 144
WG_MIN_STAGES = 4
WG_TWO_BLOCKS_BN = 64
WG_MIN_SPLIT = 48
# the narrowest calls, which the pipe body takes (pw_body)
WG_NARROW_K = 32
WG_NARROW_N = 64
SMEM_PER_SM = 228 * 1024      # an SM's shared memory, 1 KB of it per block
H100_SMS = 132
# The largest K the pipe body's plan fits (its W slice of one 16-row mma
# tile pair beside the shallowest ring; pw_gemm.cuh's pipe_plan).
PIPE_MAX_K = 4096


def _subsample(x: torch.Tensor, strides: Sequence[int]) -> torch.Tensor:
    if tuple(strides) == (1, 1, 1):
        return x
    st, sh, sw = strides
    if st != 1 or x.dim() != 5:
        raise ValueError(f"a strided 1x1x1 conv takes a 5-D input and "
                         f"strides (1, sh, sw), got {tuple(strides)}")
    return x[:, :, ::sh, ::sw, :]


def pointwise_conv3d_reference(x: torch.Tensor, weight: torch.Tensor,
                               strides: Sequence[int] = (1, 1, 1),
                               bias: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Plain version: subsample, then ``F.linear`` in x's dtype.  A
    subsampled x is copied first: on a strided view ``torch.matmul`` takes
    one GEMM or a batch of them by whether the weight requires grad, which
    changes the sums' order (a custom op's or a checkpoint's forward sees
    tensors that do not)."""
    xs = _subsample(x, strides)
    if xs is not x:
        xs = xs.contiguous()
    return F.linear(xs, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype))


def routes_to_kernel(x_shape: Sequence[int], has_bias: bool,
                     strides: Sequence[int] = (1, 1, 1)) -> bool:
    """Whether a 1x1x1 conv on an input of this shape is a bulk conv (K7 on
    a CUDA tensor): 5-D, more than one output position, no bias."""
    if len(x_shape) != 5 or has_bias:
        return False
    _, sh, sw = strides
    positions = x_shape[1] * -(-x_shape[2] // sh) * -(-x_shape[3] // sw)
    return positions > 1


def pw_body(K: int, N: int, M: int, strides: Sequence[int] = (1, 1, 1),
            aligned: int = 16, elem: int = 2, width: int = 1,
            height: int = 1) -> str:
    """Which of K7's bodies computes a call: (M, K) @ (K, N) at ``strides``
    on an input plane ``height`` x ``width``, ``elem``-byte values, x, w and
    y all ``aligned``-byte aligned.

    * "wg": bfloat16, K % 8 == 0 (a row of x or W a multiple of 16 bytes,
      as a TMA tensor map needs), 16-byte aligned, M below 2^31 (a TMA
      coordinate), N a multiple of 8 or even and at most one column tile
      wide -- but not the narrowest calls, K <= WG_NARROW_K with
      N <= WG_NARROW_N (X3D's stage-2 conv a: 64-row tiles of 3 KB of x
      and 7 KB of y, which the pipe body's 32 warps an SM keep in flight
      better).  A strided call also needs strides of at most 8 and a plane
      at most 256 wide (a tensor map's box) with output rows that fit a
      128-row tile, one column tile (its tiles' rows of y stop inside a
      frame, and only the bulk copy of contiguous rows stops there with
      them), pixels of at least 128 bytes (K >= 64: the gathered pixels are
      then whole lines) and output frames of at least half a 64-row tile;
    * "pipe": any other bfloat16 call with an even K up to PIPE_MAX_K and
      4-byte aligned x and w -- at X3D widths K = 54, 108 (rows of 108 and
      216 bytes), stage 2's conv a and the strided projections but stage
      5's at X3D-M;
    * "cuda_core": float32, and bfloat16 that neither takes.
    The limits on narrow and strided calls are where the wg body measured
    behind the pipe body on an H100 (PERF.md §6)."""
    if elem != 2:
        return "cuda_core"
    _, sh, sw = strides
    Ho, Wo = -(-height // sh), -(-width // sw)
    if (K % 8 == 0 and aligned % 16 == 0 and M < 2 ** 31
            and (N % 8 == 0 or (N % 2 == 0 and N <= WG_COLUMNS[-1]))
            and not (K <= WG_NARROW_K and N <= WG_NARROW_N)
            and ((sh, sw) == (1, 1)
                 or (sh <= 8 and sw <= 8 and width <= 256 and N <= 256
                     and Wo <= 2 * WG_ROWS and K >= WG_BK
                     and Ho * Wo >= WG_ROWS // 2))):
        return "wg"
    if K % 2 == 0 and K <= PIPE_MAX_K and aligned % 4 == 0:
        return "pipe"
    return "cuda_core"


def _columns(N: int, nct: int):
    """The narrowest instantiated column tile of at least ceil(N / nct)
    columns, and the column tiles it takes to cover N."""
    bn = min(c for c in WG_COLUMNS if c >= -(-N // nct))
    return bn, -(-N // bn)


def wg_smem(K: int, bn: int, cons: int, stages: int, resident: bool,
            epilogue: bool = False) -> int:
    """Dynamic shared memory of a wg block, as ``wg_smem`` in pw_wgmma.cuh
    lays it out: slack and mbarriers, the resident W slice (k-tiles of bn
    rows of 128 bytes), the ring (a stage: 64 cons rows of x as a 128-byte
    k-tile, and a W k-tile where W streams), the consumers' y buffers
    (WG_OUT_BUFS of 64 x bn bfloat16 each), and with the BN ``epilogue``
    its float32 mul and add of the block's bn columns."""
    nk = -(-K // WG_BK)
    w_tile = bn * 2 * WG_BK
    stage = cons * WG_ROWS * 2 * WG_BK + (0 if resident else w_tile)
    return (WG_ALIGN + WG_HEAD + (nk * w_tile if resident else 0)
            + stages * stage + WG_OUT_BUFS * cons * WG_ROWS * bn * 2
            + (8 * bn if epilogue else 0))


@functools.lru_cache(maxsize=None)
def wg_plan(M: int, K: int, N: int, sms: int = H100_SMS,
            plane: Optional[tuple] = None, epilogue: bool = False) -> dict:
    """How the wg body runs (M, K) @ (K, N) on a card of ``sms`` SMs; a
    strided call gives ``plane`` = (frames, H, W, sh, sw) of its input; a
    call with the BN ``epilogue`` keeps its coefficients in shared memory
    beside the rest (:func:`wg_smem`).

    Column tiles: one where N fits 256 columns, else the fewest of at most
    WG_SPLIT_BN (N = 432: three of 144, faster than two of 216), snapped up
    to an instantiated width (WG_COLUMNS); where N % 8 == 0 and 64-row tiles
    times column tiles leave SMs idle, narrower ones (down to WG_MIN_SPLIT),
    so that the grid fills the card (stage 5's 7 840 rows: two column tiles
    of 96 where one of 192 leaves SMs idle).  Rows and blocks: two consumer
    warpgroups (128-row tiles: fewer, larger loads, W read once for 128
    rows) where their ring keeps WG_MIN_STAGES stages (a row tile's
    k-tiles where fewer), else one (64-row
    tiles); two blocks an SM where column tiles are narrow (four
    warpgroups an SM keep more of the small tiles' stores in flight), else
    one; ``slots`` row-tile slots per column tile, a
    block walking row tiles slot, slot + slots, ...  A strided row tile is
    ``rows_per_tile`` whole output rows of one frame (as many as the tile
    holds), read in place; else 64 or 128 rows of x as a matrix.  W: resident
    where the row tiles a block walks repay loading the slice whole before
    the first product (WG_RESIDENT_PER_TILE a tile, at most WG_RESIDENT_MAX,
    beside WG_MIN_STAGES stages, or a row tile's k-tiles if fewer), else
    streamed beside x in each stage.
    Stages: as many as the block's share of shared memory holds, up to
    WG_MAX_STAGES.  (Chosen by A/B on an H100: PERF.md §6.)

    Keys: ``block_rows``, ``consumers``, ``block_columns``,
    ``column_tiles``, ``k_tiles``, ``tiles``, ``rows_per_tile`` (0 at
    stride 1), ``slots``, ``blocks``, ``blocks_per_sm``,
    ``tiles_per_block`` (the most a block walks), ``w_resident``,
    ``stages``, ``smem_bytes``, ``cluster`` (blocks sharing W by TMA
    multicast: 1, none)."""
    if M < 1 or K < 1 or N < 1:
        raise ValueError(f"empty product ({M}, {K}) x ({K}, {N})")
    def row_tiles(cons):
        """(row tiles, output rows of Wo a tile: 0 at stride 1)."""
        if plane is None:
            return -(-M // (cons * WG_ROWS)), 0
        frames, H, W, sh, sw = plane
        Ho, Wo = -(-H // sh), -(-W // sw)
        r = min(Ho, cons * WG_ROWS // Wo)
        return (frames * -(-Ho // r), r) if r else (0, 0)

    bn, nct = _columns(N, 1 if N <= WG_COLUMNS[-1] else -(-N // WG_SPLIT_BN))
    tiles64 = max(row_tiles(1)[0], row_tiles(2)[0])
    while plane is None and N % 8 == 0 and tiles64 * nct < sms:
        wider = [_columns(N, n) for n in range(nct + 1, N // 8 + 1)]
        split = [(b, n) for b, n in wider if n > nct and b >= WG_MIN_SPLIT]
        if not split:
            break
        bn, nct = split[0]
    nk = -(-K // WG_BK)

    def layout(cons, per_sm):
        budget = min(MAX_SMEM, SMEM_PER_SM // per_sm - 1024)
        tiles, r = row_tiles(cons)
        slots = max(1, min(tiles, per_sm * sms // nct))
        per_block = -(-tiles // slots)

        def stages(resident):
            fixed = wg_smem(K, bn, cons, 0, resident, epilogue)
            stage = wg_smem(K, bn, cons, 1, resident, epilogue) - fixed
            return min(WG_MAX_STAGES, (budget - fixed) // stage)

        w_bytes = nk * bn * 2 * WG_BK
        resident = (w_bytes <= min(WG_RESIDENT_MAX,
                                   per_block * WG_RESIDENT_PER_TILE)
                    and stages(True) >= min(WG_MIN_STAGES, nk))
        n_stages = stages(resident)
        return {"block_rows": cons * WG_ROWS, "consumers": cons,
                "block_columns": bn, "column_tiles": nct, "k_tiles": nk,
                "tiles": tiles, "rows_per_tile": r, "slots": slots,
                "blocks": slots * nct, "blocks_per_sm": per_sm,
                "tiles_per_block": per_block,
                "w_resident": int(resident), "stages": n_stages,
                "smem_bytes": wg_smem(K, bn, cons, n_stages, resident,
                                      epilogue),
                "cluster": 1}

    # a strided row tile holds whole output rows of one frame: two
    # warpgroups only where a frame has more rows than one holds
    two = plane is None or row_tiles(2)[1] * -(-plane[2] // plane[4]) \
        > WG_ROWS
    for cons, per_sm in ((2, 2), (2, 1)) if two else ():
        if per_sm == 2 and bn > WG_TWO_BLOCKS_BN:
            continue
        p = layout(cons, per_sm)
        if p["stages"] >= min(WG_MIN_STAGES, nk) and p["tiles"]:
            return p
    p = layout(1, 1)
    # output rows wider than 64 need a 128-row tile, at any ring depth
    return p if p["tiles"] else layout(2, 1)


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(lib, body: str, x: torch.Tensor, w: torch.Tensor,
            strides: Sequence[int], stream, plan: Optional[dict] = None,
            bn: tuple = epilogue.NO_POINTERS) -> torch.Tensor:
    """K7's ``body`` on x (B, T, H, W, K) and w (N, K) (contiguous, one
    dtype, on a CUDA device); returns y or raises.  ``plan`` overrides the
    wg body's :func:`wg_plan` (the same keys); ``bn`` is the epilogue's
    (mul, add, relu) arguments (``epilogue.pointers``)."""
    B, T, H, W, K = x.shape
    N = w.shape[0]
    _, sh, sw = strides
    y = torch.empty((B, T, -(-H // sh), -(-W // sw), N), dtype=x.dtype,
                    device=x.device)
    if body == "wg":
        plane = None if (sh, sw) == (1, 1) else (B * T, H, W, sh, sw)
        p = plan or wg_plan(y.numel() // N, K, N, _sms(x.device), plane,
                            bn[0] is not None)
        rc = lib.x3d_pw_conv_wg(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), B * T, H, W, K, N, sh,
            sw, p["block_columns"], p["consumers"], p["column_tiles"],
            p["slots"], p["stages"], p["w_resident"], p["rows_per_tile"],
            *bn, stream)
    else:
        rc = lib.x3d_pw_conv(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                             kernels.dtype_code(x), B * T, H, W, K, N, sh,
                             sw, int(body == "pipe"), *bn, stream)
    kernels.raise_on_error(rc, f"pw_conv ({body} body) kernel launch")
    return y


def cost(M: int, K: int, N: int, elem: int) -> Tuple[int, int]:
    """A K7 call's (bytes, flops): the M rows of x it reads (a strided
    projection's subsample) and the weight read, y written; 2 M K N."""
    return (M * (K + N) + N * K) * elem, 2 * M * K * N


def pw_conv(x: torch.Tensor, weight: torch.Tensor,
            strides: Sequence[int] = (1, 1, 1),
            direction: str = "fwd", mul: Optional[torch.Tensor] = None,
            add: Optional[torch.Tensor] = None,
            relu: bool = False) -> torch.Tensor:
    """y = x[:, :, ::sh, ::sw] @ weight^T (kernel K7).

    Args:
      x: (B, T, H, W, Cin) float32 or bfloat16.
      weight: (Cout, Cin), rounded to x's dtype.
      strides: (1, sh, sw).
      mul, add: (Cout,) float32, an eval BatchNorm applied to y, and
        ``relu`` a ReLU after it (``ops/epilogue.py``); None: y alone.

    Returns:
      y (B, T, ceil(H/sh), ceil(W/sw), Cout) in x's dtype, summed in
      float32 and rounded once (through the epilogue where one is given).

    A CPU tensor takes the plain version; a CUDA tensor launches K7 or
    raises.  ``direction`` ("fwd", or "bwd" for the backward's dx) goes
    into an open ``ops.launch_log`` only.
    """
    if x.dim() != 5 or weight.dim() != 2 or weight.shape[1] != x.shape[-1]:
        raise ValueError(f"expected x (B, T, H, W, Cin) and weight (Cout, "
                         f"Cin), got {tuple(x.shape)} and "
                         f"{tuple(weight.shape)}")
    st, sh, sw = (int(s) for s in strides)
    if st != 1 or sh < 1 or sw < 1:
        raise ValueError(f"strides must be (1, sh, sw), got {tuple(strides)}")
    M = x.shape[0] * x.shape[1] * -(-x.shape[2] // sh) * -(-x.shape[3] // sw)
    K, N = x.shape[-1], weight.shape[0]
    epilogue.check(mul, add, relu, N)
    bn = epilogue.kind(mul, relu)
    if x.device.type == "cpu":
        body = "plain"
        y = epilogue.reference(
            pointwise_conv3d_reference(x, weight, (st, sh, sw)), mul, add,
            relu)
    else:
        kernels.check_cuda(x)
        w = weight.to(x.dtype).contiguous()
        coefs = epilogue.prepare(mul, add, x)
        kernels.check_cuda(x, w, *(coefs or ()))
        lib = epilogue.library("pointwise.cu", _SIGNATURES, coefs)
        body = pw_body(K, N, M, (st, sh, sw), ring.align(x, w),
                       x.element_size(), x.shape[3], x.shape[2])
        y = _launch(lib, body, x, w, (st, sh, sw), kernels.stream_handle(x),
                    bn=epilogue.pointers(coefs, relu))
        pw_conv.launches += 1
        pw_conv.body_launches[body] += 1
        if coefs is not None:
            pw_conv.epilogue_launches[bn] += 1
    if ops.records is not None:
        ops.log_launch("K7", body, {"M": M, "K": K, "N": N}, direction,
                       x.dtype, epilogue.cost(bn, N, M * N, cost(
                           M, K, N, x.element_size())), bn)
    return y


pw_conv.launches = 0
pw_conv.body_launches = {"wg": 0, "pipe": 0, "cuda_core": 0}
pw_conv.epilogue_launches = epilogue.counter()


def plan(x_shape: Sequence[int], N: int, strides: Sequence[int] = (1, 1, 1),
         aligned: int = 16, dtype: torch.dtype = torch.bfloat16) -> dict:
    """How K7 runs on an input of ``x_shape`` (B, T, H, W, K) with N output
    channels on this process's card: ``body`` (:func:`pw_body`) and its
    layout -- the wg body's :func:`wg_plan`, the pipe body's report (keys
    ``kernels.PLAN_KEYS``), nothing more for the CUDA cores.  Builds the
    kernel for the pipe body; needs a CUDA card."""
    B, T, H, W, K = x_shape
    _, sh, sw = strides
    M = B * T * -(-H // sh) * -(-W // sw)
    body = pw_body(K, N, M, strides, aligned, torch.finfo(dtype).bits // 8,
                   W, H)
    if body == "wg":
        plane = None if (sh, sw) == (1, 1) else (B * T, H, W, sh, sw)
        return {"body": body,
                **wg_plan(M, K, N, _sms(torch.device("cuda")), plane)}
    if body == "pipe":
        lib = _build.load("pointwise.cu", _SIGNATURES)
        return {"body": body, **kernels.read_plan(lib.x3d_pw_conv_plan, K, N)}
    return {"body": body}


class _Pointwise(torch.autograd.Function):
    """K7 forward (where ``ops.via_library()`` holds -- export, a remat
    "convs" region -- the op ``x3d::pw_conv``, ``ops/library.py``);
    backward: dx = K7 on the cotangent and the
    transposed weight (scattered back onto the strided positions), dW =
    g^T x in float32."""

    @staticmethod
    def forward(ctx, x, weight, strides):
        ctx.save_for_backward(x, weight)
        ctx.strides = strides
        if ops.via_library():
            from x3d_tpu_torch.ops import library
            return library.pw_conv(x, weight, strides)
        return pw_conv(x, weight, strides)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        strides = ctx.strides
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dxs = pw_conv(g, weight.to(x.dtype).t(), (1, 1, 1), "bwd")
            if strides == (1, 1, 1):
                dx = dxs
            else:
                dx = torch.zeros_like(x)
                dx[:, :, ::strides[1], ::strides[2], :] = dxs
        if ctx.needs_input_grad[1]:
            xs = _subsample(x, strides)
            K, N = weight.shape[1], weight.shape[0]
            dw = torch.matmul(g.reshape(-1, N).to(torch.float32).t(),
                              xs.reshape(-1, K).to(torch.float32))
            dw = dw.to(weight.dtype)
        return dx, dw, None


def pointwise_conv3d(x: torch.Tensor, weight: torch.Tensor,
                     strides: Sequence[int] = (1, 1, 1),
                     bias: Optional[torch.Tensor] = None,
                     mul: Optional[torch.Tensor] = None,
                     add: Optional[torch.Tensor] = None,
                     relu: bool = False) -> torch.Tensor:
    """x: (..., Cin) in the compute dtype; weight: (Cout, Cin).

    A bulk conv (:func:`routes_to_kernel`) runs K7 and its backward -- on a
    CPU tensor their plain versions -- unless ``ops.plain_versions()`` is
    on; everything else is ``F.linear``.  ``mul``, ``add`` and ``relu``:
    an eval BatchNorm after the conv (``ops/epilogue.py``; forward only),
    K7's epilogue where K7 runs, else the plain version after the conv."""
    strides = tuple(int(s) for s in strides)
    epilogue.forward_only(mul, x, weight, add)
    if ops.plain_versions_enabled() \
            or not routes_to_kernel(x.shape, bias is not None, strides):
        return epilogue.reference(
            pointwise_conv3d_reference(x, weight, strides, bias), mul, add,
            relu)
    if mul is not None:
        if ops.via_library():
            from x3d_tpu_torch.ops import library
            return library.pw_conv(x.contiguous(), weight, strides, mul, add,
                                   relu)
        return pw_conv(x.contiguous(), weight, strides, "fwd", mul, add,
                       relu)
    return _Pointwise.apply(x.contiguous(), weight, strides)
