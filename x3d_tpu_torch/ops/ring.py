"""Launch plans of the ring bodies: K1's (``ops/depthwise``), K2's and K3's
(``ops/dw_fused``).

A ring body's block owns one clip, a tile of output pixels, a group of
channel vectors and a run of frames, and stages each input plane of its tile
and halo once into a shared-memory ring of planes.  How a call runs -- the
tile, the groups, the thread rows, the pitches that spread a warp's loads
over the banks, the runs -- is decided here, in pure Python, so that the
CPU tests can check it; the kernels' limits and geometry (``common.cuh``:
``kRingMaxKt``, ``kRingMaxVecs``, ``kRingMaxThreads``, ``kRingAhead``,
``RingGeom``, ``ring_geometry``, ``ring_rows``, ``ring_cols``) mirror the
constants and rules here: change both.
"""

from __future__ import annotations

import ctypes
import functools

from x3d_tpu_torch import kernels

RING_MAX_KT = 5
RING_MAX_VECS = 32
RING_MAX_THREADS = 128    # a role's (K3's block has a du and a dk role)
RING_AHEAD = 1            # planes in flight beyond the newest
RING_MAX_SIDE = 14        # a plane up to this side is one tile (stride 1)
RING_MAX_SIDE_2 = 8       # ... at stride 2, whose halo is four times larger
RING_MIN_RUN = 4          # frames a run keeps (each reloads kt - 1 planes)


def ring_side(n: int, stride: int = 1) -> int:
    """A tile's side along n output pixels: n itself up to the most side
    (RING_MAX_SIDE at stride 1, RING_MAX_SIDE_2 at stride 2), else the side
    from half the most up to it that leaves the fewest idle pixels (the
    larger on a tie)."""
    most = RING_MAX_SIDE if stride == 1 else RING_MAX_SIDE_2
    if n <= most:
        return n
    best = most
    for side in range(most - 1, most // 2 - 1, -1):
        if -(-n // side) * side < -(-n // best) * best:
            best = side
    return best


def ring_rows(tile_h: int, stride: int = 1) -> int:
    """Staged rows of a tile of ``tile_h`` output rows under 3 taps
    (common.cuh's ring_rows)."""
    return (tile_h - 1) * stride + 3


def ring_cols(tile_w: int, stride: int = 1) -> int:
    """The fewest cells of a staged row (common.cuh's ring_cols), input
    columns in order: the tile's and its halo's, and at odd ``tile_w``
    those that the idle half of its last pair of pixels reads."""
    return stride * (tile_w - 1 + tile_w % 2) + 3


def ring_slot(nv, vec, elem, tile_h, row_cells, vec_pad,
              stride: int = 1) -> int:
    """Bytes of one ring slot: nv vector planes of :func:`ring_rows` rows of
    ``row_cells`` cells and a pad, rounded up to 16 bytes."""
    plane = ring_rows(tile_h, stride) * row_cells + vec_pad
    return -(-nv * plane * vec * elem // 16) * 16


def taps_smem(kt, vec, group) -> int:
    """Bytes of taps a ring-body block keeps in shared memory (common.cuh's
    ring_taps_shared): none where they fit in registers."""
    return 9 * kt * group * 4 if 9 * kt * vec > 64 else 0


def bank_ways(nv: int, threads: int, cell: int, plane: int, row: int) -> int:
    """Shared-memory wavefronts of one tap load over a block's warps, where
    thread i = (cv, r) = (i % nv, i // nv) reads a cell of ``cell`` bytes at
    cv * plane + r * row cells: per warp (per half-warp for 8 bytes), the
    most distinct 4-byte words that one of the 32 banks serves."""
    total = 0
    per = 16 if cell == 8 else 32
    for first in range(0, threads, per):
        banks = {}
        for i in range(first, min(first + per, threads)):
            at = (i % nv * plane + i // nv * row) * cell
            for word in range(at // 4, (at + cell - 1) // 4 + 1):
                banks.setdefault(word % 32, set()).add(word)
        total += max(len(words) for words in banks.values())
    return total


@functools.lru_cache(maxsize=None)
def ring_pitch(nv, threads, cell, tile_h, tile_w, stride: int = 1):
    """(cells a staged row, cells padding a vector plane): a row holds at
    least :func:`ring_cols` cells and up to 7 more; the pair that spreads a
    warp's tap loads over the banks best (thread row r reads staged row
    stride * r), then the smaller plane."""
    least = ring_cols(tile_w, stride)
    rows = ring_rows(tile_h, stride)
    return min(((cols, pad) for cols in range(least, least + 8)
                for pad in range(32)),
               key=lambda cp: (bank_ways(nv, threads, cell,
                                         rows * cp[0] + cp[1],
                                         stride * cp[0]),
                               rows * cp[0] + cp[1]))


def plan(B, T, H, W, C, elem, align, slots, role_threads, budget, smem_of,
         row_a_thread=False, stride=1):
    """What the ring bodies' plans share, for an output of (B, T, H, W, C)
    at spatial ``stride``: the granule, the tile, channel groups whose block
    fits ``budget`` bytes of shared memory by ``smem_of(vec, tile_h,
    row_cells, vec_pad, group, rows)``, thread rows of a role of at most
    ``role_threads`` threads (with ``row_a_thread``, groups small enough
    that each thread takes one tile row), the pitches and the runs (T is
    cut while the blocks would not fill the card's ``slots`` twice over,
    keeping runs of RING_MIN_RUN frames or more)."""
    vec = 2 if C % 2 == 0 else 1
    cell = vec * elem
    granule = cell if cell >= 4 and align % cell == 0 else elem
    tile_h, tile_w = ring_side(H, stride), ring_side(W, stride)
    most = RING_MAX_VECS * vec
    if row_a_thread:
        most = min(most, max(1, role_threads // tile_h) * vec)
    for groups in range(-(-C // most), C + 1):
        group = -(-(-(-C // groups)) // vec) * vec
        nv = group // vec
        passes = -(-tile_h // max(1, role_threads // nv))
        rows = -(-tile_h // passes)
        row_cells, vec_pad = ring_pitch(nv, nv * rows, cell, tile_h, tile_w,
                                        stride)
        smem = smem_of(vec, tile_h, row_cells, vec_pad, group, rows)
        if group <= most and smem <= budget:
            break
    else:
        raise ValueError(f"no ring-body plan fits C={C}")
    groups = -(-C // group)
    tiles_h, tiles_w = -(-H // tile_h), -(-W // tile_w)
    blocks = groups * tiles_h * tiles_w * B
    runs = 1
    while blocks * runs < 2 * slots and -(-T // (runs + 1)) >= RING_MIN_RUN:
        runs += 1
    run = -(-T // runs)
    runs = -(-T // run)
    return dict(granule=granule, vec=vec, tile_h=tile_h, tile_w=tile_w,
                tiles_h=tiles_h, tiles_w=tiles_w, group=group, groups=groups,
                rows=rows, warps=-(-nv * rows // 32), row_cells=row_cells,
                vec_pad=vec_pad, smem_bytes=smem, run=run, runs=runs,
                parts=B * tiles_h * tiles_w * runs)


_slots = {}


def card_slots(lib, query: str, *args: int) -> int:
    """Blocks of one shape that the card holds at once (blocks an SM x
    SMs), from the library's occupancy query ``query(*args, out)``."""
    key = (query, *args)
    if key not in _slots:
        out = (ctypes.c_int * 2)()
        kernels.raise_on_error(getattr(lib, query)(
            *args, ctypes.addressof(out)), query)
        _slots[key] = out[0] * out[1]
    return _slots[key]


def align(*tensors) -> int:
    """The largest power of two up to 16 dividing every tensor's address."""
    return min(16, *(t.data_ptr() & -t.data_ptr() for t in tensors))
