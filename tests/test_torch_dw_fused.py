"""The port's fused segment (BN affine + ReLU -> depthwise conv -> sums)
against the JAX package, and kernel K2 against its plain version on the
card.

On the CPU the wrapper runs its plain version; it is held against
``dw_fused.reference`` and against JAX's Pallas kernel
``dw_fused.dw_bn_act_conv`` in interpret mode.  Coefficients are per-sample (C, B) columns with
offsets of both signs: relu(a*0 + b) > 0 where b > 0, so zero-padding x
instead of u would show at the borders.  Tolerances (float32): y atol
1e-5; p and s2 rtol 1e-5 with atol 1e-5 (sums of a few hundred terms in
another order).

K2 has two bodies on the card: :func:`dw_fused.segment_body` sends 3x3
spatial taps with 1 to 5 temporal ones to the ring body and every other
geometry to the generic body (its cases are in test_torch_dw_fused_bwd.py,
as K3 shares it).  The ring body's launch plan (:func:`dw_fused.fwd_plan`)
is checked here at every fused-segment shape of the five variants, at the
serving, eval and training batches, and its per-(clip, tile, run) partial
sums are rebuilt in numpy in the second pass's fixed order against the
plain version's sums (float32, another order: within 1e-5 of the sums over
absolute values).

With an eval BatchNorm as its epilogue (bn_b, ``ops/epilogue.py``) the
plain version is the plain segment followed by the model's affine, bit for
bit, and p and s2 stay the segment's sums; on the card each body's
epilogue equals its launch without one followed by that affine, bit for
bit.

JAX is imported inside the tests, so that the card tests (marker ``cuda``)
run on a machine without it:
``python -m pytest --noconftest -m cuda tests/test_torch_dw_fused.py``.
"""

import ctypes

import numpy as np
import pytest
import torch

from x3d_tpu_torch import ops, variant_config
from x3d_tpu_torch.models import build_arch
from x3d_tpu_torch.models.x3d import affine
from x3d_tpu_torch.ops import (dw_fused, epilogue, library, plain_versions,
                               ring)

KDIMS = [(3, 3, 3), (3, 1, 1), (5, 3, 3)]
SHAPES = [(3, 5, 6, 5, 7), (2, 5, 4, 9, 3)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, shape, kdims):
    rng = np.random.default_rng(seed)
    B, C = shape[0], shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    a = (0.5 + rng.uniform(size=(C, B))).astype(np.float32)
    b = (0.3 * rng.normal(size=(C, B))).astype(np.float32)
    b[0, :] = 0.4                                  # a channel all positive
    k = (0.3 * rng.normal(size=kdims + (1, C))).astype(np.float32)
    return x, a, b, k


def _port(*arrays):
    return [t.numpy() for t in
            dw_fused.dw_bn_act_conv(*(torch.from_numpy(a) for a in arrays))]


def _assert_matches(got, want):
    y, p, s2 = (np.asarray(w) for w in want)
    assert got[0].shape == y.shape and got[1].shape == p.shape
    np.testing.assert_allclose(got[0], y, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1], p, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[2], s2, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kdims", KDIMS)
@pytest.mark.parametrize("shape", SHAPES)
def test_matches_jax_reference(kdims, shape):
    from x3d_tpu.ops import dw_fused as jax_dw_fused

    args = _inputs(0, shape, kdims)
    _assert_matches(_port(*args), jax_dw_fused.reference(*args))


# The interpreted Pallas kernel unrolls rows x taps x ring phases, so its
# trace grows with H and the kernel size: few rows and the serving path's
# 3x3x3 taps here (the 5x3x3 case is held against the reference above).
@pytest.mark.parametrize("shape,kdims", [
    ((3, 4, 2, 5, 7), (3, 3, 3)), ((2, 5, 4, 9, 3), (3, 1, 1))])
def test_matches_jax_pallas_kernel(shape, kdims):
    import jax
    from x3d_tpu.ops import dw_fused as jax_dw_fused

    args = _inputs(1, shape, kdims)
    old = jax_dw_fused.INTERPRET
    jax_dw_fused.INTERPRET = True
    try:
        want = jax.jit(jax_dw_fused.dw_bn_act_conv)(*args)
    finally:
        jax_dw_fused.INTERPRET = old
    _assert_matches(_port(*args), want)


def test_border_is_zero_u_not_zero_x():
    """x = 0 with b > 0: u = relu(b) inside the clip and 0 outside, so a
    corner output sums fewer taps than a centre one."""
    B, T, H, W, C = 1, 3, 4, 4, 2
    x = np.zeros((B, T, H, W, C), np.float32)
    a = np.ones((C, B), np.float32)
    b = np.full((C, B), 0.5, np.float32)
    k = np.ones((3, 3, 3, 1, C), np.float32)
    y = _port(x, a, b, k)[0]
    assert y[0, 1, 1, 1, 0] == pytest.approx(27 * 0.5)
    assert y[0, 0, 0, 0, 0] == pytest.approx(8 * 0.5)


def test_rejects_temporal_extent_below_kernel():
    """Named for the guard it held until the segment took fewer frames
    than temporal taps (the JAX Pallas kernel's limit, which the segment
    once copied): multigrid's coarse phases give X3D-XS 1 and 2 frames
    under 3 taps, so such clips are now taken, and taps past the clip see
    zeros, as in the JAX package's reference."""
    from x3d_tpu.ops import dw_fused as jax_dw_fused

    for shape, kdims in (((2, 3, 6, 5, 4), (5, 3, 3)),
                         ((2, 1, 6, 5, 4), (3, 3, 3)),
                         ((2, 2, 6, 5, 4), (3, 3, 3))):
        args = _inputs(1, shape, kdims)
        _assert_matches(_port(*args), jax_dw_fused.reference(*args))


def test_even_kernel_rejected():
    x, a, b, _ = _inputs(2, (2, 3, 4, 4, 4), (3, 3, 3))
    with pytest.raises(ValueError, match="odd"):
        _port(x, a, b, np.zeros((2, 3, 3, 1, 4), np.float32))


def test_non_cpu_tensor_never_falls_back():
    args = [torch.from_numpy(a).to("meta")
            for a in _inputs(3, (2, 3, 4, 4, 4), (3, 3, 3))]
    with pytest.raises(ValueError, match="CUDA"):
        dw_fused.dw_bn_act_conv(*args)


# The fused segments' (T, H, W, C): X3D-M (16 frames; stages 2-5 at 56²,
# 28², 14², 7²) and X3D-S (13 frames; 40², 20², 10², 5²), at the batches
# that run them: serving (a video, 10 clips; 8 videos, 80), X3D-S's eval (80
# clips) and training (X3D-M 32 clips, X3D-S 64)
PLANES = {"M": [(16, 56, 56, 54), (16, 28, 28, 108), (16, 14, 14, 216),
                (16, 7, 7, 432)],
          "S": [(13, 40, 40, 54), (13, 20, 20, 108), (13, 10, 10, 216),
                (13, 5, 5, 432)]}
BATCHES = {"M": (10, 80, 32), "S": (10, 80, 64)}
SEGMENTS = [(B, *thw) for v in "MS" for B in BATCHES[v] for thw in PLANES[v]]
SEGMENT_IDS = [f"{v}{i + 2}-B{B}" for v in "MS" for B in BATCHES[v]
               for i in range(4)]


def x3d_planes(variant, train, cfg=None):
    """(stage, entry, segment) of each stage of X3D-``variant`` from its
    YAML's architecture plan (or ``cfg``'s) at its training or test crop:
    the (T, H, W, C) input of the stride-2 stage entry's depthwise conv,
    and the plane of the stage's stride-1 blocks (the fused segments)."""
    cfg = cfg or variant_config(variant)
    arch = build_arch(cfg)
    T = cfg.DATA.TEMP_DURATION
    S = (cfg.DATA.TRAIN_CROP_SIZE if train else cfg.DATA.TEST_CROP_SIZE) // 2
    out = []
    for si, blocks in enumerate(arch.stages):
        C = blocks[0].inner_channels
        entry, S = (T, S, S, C), -(-S // 2)
        out.append((si + 2, entry, (T, S, S, C)))
    return out


def x3d_batches(variant):
    """(clips, training) of X3D-``variant``'s paths: a video's views and
    eight videos' (serving), the eval batch and the training batch."""
    cfg = variant_config(variant)
    views = cfg.TEST.NUM_TEMPORAL_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    return sorted({(views, False), (8 * views, False),
                   (cfg.TEST.BATCH_SIZE * views, False),
                   (cfg.TRAIN.BATCH_SIZE, True)})


# X3D-XS (4 frames at 80² .. 5²), -L and -XL (16 frames at 78², 39², 20²,
# 10²; XL's widths 72, 162, 306, 630, two of them 2 mod 4) from their YAMLs
NEW_SEGMENTS = [(f"{v}{st}-B{B}", (B, *seg)) for v in ("XS", "L", "XL")
                for B, train in x3d_batches(v)
                for st, _, seg in x3d_planes(v, train)]




def multigrid_phases(variant):
    """(phase index, config) of X3D-``variant``'s long-cycle phases under
    the default factors: batches of 2 to 8 times TRAIN.BATCH_SIZE at
    fewer frames and smaller crops (X3D-XS 1 and 2 frames, fewer than
    the 3 temporal taps)."""
    from x3d_tpu_torch.train.multigrid import MultigridSchedule

    cfg = variant_config(variant)
    return [(p.index, p.apply_to_config(cfg))
            for p in MultigridSchedule(cfg, 8, 5).phases]


# the training shapes of every variant's multigrid phases that no case
# above has
MULTIGRID_SEGMENTS = list({
    (B, *seg): f"{v}{st}-mg{i}-B{B}"
    for v in ("XS", "S", "M", "L", "XL")
    for i, c in multigrid_phases(v)
    for B in (c.TRAIN.BATCH_SIZE,)
    for st, _, seg in x3d_planes(v, True, c)
    if (B, *seg) not in set(SEGMENTS) | {s for _, s in NEW_SEGMENTS}}.items())


@pytest.mark.parametrize("shape", SEGMENTS + [s for _, s in NEW_SEGMENTS]
                         + [s for s, _ in MULTIGRID_SEGMENTS],
                         ids=SEGMENT_IDS + [i for i, _ in NEW_SEGMENTS]
                         + [i for _, i in MULTIGRID_SEGMENTS])
@pytest.mark.parametrize("elem,align", [(2, 16), (2, 2), (4, 16), (4, 4),
                                        (2, 8)])
@pytest.mark.parametrize("slots", [0, 396, 528])
def test_fwd_plan_covers_the_clip(shape, elem, align, slots):
    """Tiles cover each plane, each frame lies in exactly one run, every
    channel group starts on a copy granule (a cell of two channels where x's
    address allows), and the block fits its shared memory."""
    B, T, H, W, C = shape
    p = dw_fused.fwd_plan(B, T, H, W, C, 3, elem, align, slots)
    for n, side, tiles in ((H, p["tile_h"], p["tiles_h"]),
                           (W, p["tile_w"], p["tiles_w"])):
        assert side == n if n <= ring.RING_MAX_SIDE else 7 <= side <= 14
        assert (tiles - 1) * side < n <= tiles * side
    frames = [t for i in range(p["runs"])
              for t in range(i * p["run"], min((i + 1) * p["run"], T))]
    assert frames == list(range(T))
    assert p["runs"] == 1 or p["run"] >= ring.RING_MIN_RUN
    g, vec = p["granule"], p["vec"]
    assert vec == 2 and p["group"] % vec == 0
    assert g == (vec * elem if align % (vec * elem) == 0 else elem)
    starts = [i * p["group"] for i in range(p["groups"])]
    assert all(c * elem % g == 0 for c in starts)
    assert starts[-1] < C <= starts[-1] + p["group"]
    assert p["group"] <= ring.RING_MAX_VECS * vec
    assert p["rows"] == p["tile_h"]                   # a tile row a thread
    block = p["group"] // vec * p["rows"]             # one role
    assert block <= ring.RING_MAX_THREADS
    assert p["threads"] == -(-block // 32) * 32
    assert p["smem_bytes"] <= dw_fused.FWD_SMEM
    ring_slots = 3 + ring.RING_AHEAD               # kt 3
    assert p["smem_bytes"] >= ring_slots * p["group"] // vec * (
        (p["tile_h"] + 2) * p["row_cells"] + p["vec_pad"]) * vec * elem
    assert 0 <= p["vec_pad"] < 32
    assert 0 <= p["row_cells"] - (p["tile_w"] + 2 + p["tile_w"] % 2) < 8
    assert p["parts"] == B * p["tiles_h"] * p["tiles_w"] * p["runs"]
    blocks = p["groups"] * p["tiles_h"] * p["tiles_w"] * B
    if p["runs"] > 1:
        assert blocks * (p["runs"] - 1) < 2 * slots


def test_fwd_ring_partials_rebuild_the_sums():
    """p and s2 from per-(clip, tile, run) partials over the plan's tiles
    and runs (each a sum over the block's thread rows), summed as the
    second pass sums them (lane y of 16 takes partials y, y + 16, ... in
    double, then the lanes in order), equal the plain version's sums within
    1e-5 of the sums over absolute values."""
    shape, kt = (2, 9, 30, 17, 6), 3
    B, T, H, W, C = shape
    p = dw_fused.fwd_plan(B, T, H, W, C, kt, 4, 16, 1000)
    assert p["runs"] > 1 and p["tiles_w"] > 1 and p["tiles_h"] > 1
    args = [torch.from_numpy(v) for v in _inputs(8, shape, (kt, 3, 3))]
    y, want_p, want_s2 = (t.numpy() for t in dw_fused.reference(*args))
    parts = []                              # (clip, tile, run), as laid out
    for b in range(B):
        for th in range(p["tiles_h"]):
            for tw in range(p["tiles_w"]):
                for r in range(p["runs"]):
                    ts = slice(r * p["run"], min((r + 1) * p["run"], T))
                    yt = y[b, ts, th * p["tile_h"]:(th + 1) * p["tile_h"],
                           tw * p["tile_w"]:(tw + 1) * p["tile_w"]]
                    rows = [yt[:, i::p["rows"]] for i in range(p["rows"])]
                    s = [sum(t.sum((0, 1, 2)) for t in rows),
                         sum((t * t).sum((0, 1, 2)) for t in rows)]
                    parts.append((b, [v.astype(np.float32) for v in s]))

    def second_pass(cols):
        lanes = [np.sum([cols[k].astype(np.float64)
                         for k in range(y_, len(cols), 16)], axis=0)
                 if y_ < len(cols) else 0.0 for y_ in range(16)]
        total = np.zeros_like(cols[0], dtype=np.float64)
        for lane in lanes:
            total = total + lane
        return total.astype(np.float32)

    for i, (want, scale) in enumerate(((want_p, np.abs(y).sum((1, 2, 3)).T),
                                       (want_s2, want_s2))):
        got = np.stack([second_pass([v[i] for bb, v in parts if bb == b])
                        for b in range(B)], axis=1)
        assert np.all(np.abs(got - want) <= 1e-5 * scale + 1e-6)


class _FailingLibrary:
    """A K2 library whose ring body fails at launch; it records the calls."""

    def __init__(self):
        self.calls = []

    def x3d_dw_bn_act_conv_fwd_ring_occupancy(self, *args):
        self.calls.append("occupancy")
        ctypes.cast(args[-1], ctypes.POINTER(ctypes.c_int * 2)).contents[:] \
            = [3, 132]
        return 0

    def x3d_dw_bn_act_conv_fwd_ring(self, *args):
        self.calls.append("ring")
        return 1                                   # cudaErrorInvalidValue

    def __getattr__(self, name):                   # the generic body's
        raise AssertionError(f"fell back to {name}")


def test_failed_ring_launch_raises_without_fallback():
    """A ring-body launch that returns an error raises; the generic body
    is never asked to take over."""
    x, a, b, k = (torch.from_numpy(v)
                  for v in _inputs(9, (2, 5, 6, 6, 8), (3, 3, 3)))
    lib = _FailingLibrary()
    ring._slots.clear()
    with pytest.raises(RuntimeError, match=r"ring body.*CUDA error 1"):
        dw_fused._launch_fwd(lib, "ring", x, a, b,
                             k.reshape(27, 8).contiguous(), (3, 3, 3), 0)
    ring._slots.clear()
    assert lib.calls == ["occupancy", "ring"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kdims", [
    ((3, 5, 6, 5, 7), (3, 3, 3)), ((2, 5, 4, 9, 3), (5, 3, 3)),
    ((3, 6, 9, 17, 70), (3, 3, 3)), ((2, 16, 7, 7, 432), (3, 3, 3)),
    ((2, 8, 10, 10, 7), (5, 3, 3)), ((2, 7, 9, 11, 70), (5, 3, 3)),
    ((2, 5, 8, 8, 6), (1, 3, 3)), ((2, 5, 8, 9, 7), (1, 3, 3)),
    ((2, 5, 6, 7, 6), (3, 5, 5)),
    # fewer frames than temporal taps (multigrid's coarse phases)
    ((2, 1, 6, 5, 7), (3, 3, 3)), ((2, 2, 4, 9, 3), (3, 3, 3)),
    ((2, 1, 7, 7, 432), (3, 3, 3)), ((2, 2, 9, 11, 70), (5, 3, 3)),
    ((2, 3, 8, 9, 70), (5, 3, 3)), ((2, 2, 6, 7, 6), (3, 5, 5))] + [
    ((2, *s[1:]), (3, 3, 3)) for s in SEGMENTS if s[0] == 10])
def test_kernel_matches_plain_on_card(cuda, dtype, shape, kdims):
    """float32: y atol 1e-4, p and s2 within 1e-5 of each column's absolute
    sum; bfloat16 against the plain version in float32 on the same
    bfloat16 inputs: 2e-2 of the largest |y| and of the column sums.  3x3
    spatial taps run the ring body (every X3D-M and X3D-S segment shape at 2
    clips), 5x5 the generic body, and the counters say which."""
    x, a, b, k = (torch.from_numpy(v).to(cuda)
                  for v in _inputs(4, shape, kdims))
    x, k = x.to(dtype), k.to(dtype)
    body = "ring" if kdims[1:] == (3, 3) else "generic"
    assert dw_fused.segment_body(kdims) == body
    fn = dw_fused.dw_bn_act_conv
    before = (fn.launches, dict(fn.body_launches))
    y, p, s2 = fn(x, a, b, k)
    torch.cuda.synchronize()
    assert fn.launches == before[0] + 1
    assert fn.body_launches == before[1] | {body: before[1][body] + 1}
    _assert_matches_plain((y, p, s2), (x, a, b, k), dtype)


def _assert_matches_plain(got, inputs, dtype):
    x, a, b, k = inputs
    y, p, s2 = got
    yr, pr, s2r = dw_fused.reference(x.float(), a, b, k.float())
    scale = yr.abs().sum(dim=(1, 2, 3)).t()
    tol_y, tol_s = (1e-4, 1e-5) if dtype == torch.float32 else \
        (2e-2 * yr.abs().max().item(), 2e-2)
    assert y.dtype == dtype
    assert (y.float() - yr).abs().max().item() <= tol_y
    assert ((p - pr).abs() <= tol_s * scale).all()
    assert ((s2 - s2r).abs() <= tol_s * s2r).all()


def _on_card_at(t, offset_bytes):
    """``t`` copied into a CUDA tensor that starts ``offset_bytes`` into its
    allocation."""
    n = offset_bytes * 8 // torch.finfo(t.dtype).bits
    buf = torch.empty(n + t.numel(), dtype=t.dtype, device=t.device)
    out = buf[n:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,offset", [
    (torch.bfloat16, 2), (torch.bfloat16, 4), (torch.bfloat16, 8),
    (torch.bfloat16, 16), (torch.float32, 4), (torch.float32, 8),
    (torch.float32, 16)])
@pytest.mark.parametrize("shape", [(2, 5, 28, 28, 54), (2, 5, 14, 14, 108),
                                   (2, 5, 14, 14, 216)],
                         ids=["C54", "C108", "C216"])
def test_ring_body_takes_unaligned_inputs(cuda, dtype, offset, shape):
    """x starting 2 to 16 bytes into its allocation (y is the wrapper's own
    allocation, written a cell at a time): the copy granule shrinks to what
    x's address allows; results as above."""
    x, a, b, k = (torch.from_numpy(v).to(cuda)
                  for v in _inputs(6, shape, (3, 3, 3)))
    x, k = _on_card_at(x.to(dtype), offset), k.to(dtype)
    assert x.data_ptr() % 32 == offset % 32
    got = dw_fused.dw_bn_act_conv(x, a, b, k)
    assert got[0].data_ptr() % 16 == 0
    _assert_matches_plain(got, (x, a, b, k), dtype)


@pytest.mark.cuda
def test_failed_ring_launch_raises_on_card(cuda, monkeypatch):
    """A plan the ring body cannot run (no thread rows) makes its launch
    fail: the call raises and counts no launch; nothing else runs it."""
    x, a, b, k = (torch.from_numpy(v).to(cuda)
                  for v in _inputs(9, (2, 5, 6, 6, 8), (3, 3, 3)))
    plan = dw_fused._fwd_ring_plan
    monkeypatch.setattr(dw_fused, "_fwd_ring_plan",
                        lambda *args: plan(*args) | {"rows": 0})
    fn = dw_fused.dw_bn_act_conv
    before = (fn.launches, dict(fn.body_launches))
    with pytest.raises(RuntimeError, match="ring body"):
        fn(x.bfloat16(), a, b, k.bfloat16())
    assert (fn.launches, fn.body_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SEGMENTS, ids=SEGMENT_IDS)
def test_ring_body_repeats_bit_for_bit(cuda, shape):
    """No atomics: y is written once and the sums are taken in a fixed
    order, so bfloat16 calls on one input give equal bits, at the full
    serving, eval and training batches."""
    x, a, b, k = (torch.from_numpy(v).to(cuda)
                  for v in _inputs(7, shape, (3, 3, 3)))
    x, k = x.bfloat16(), k.bfloat16()
    first = dw_fused.dw_bn_act_conv(x, a, b, k)
    second = dw_fused.dw_bn_act_conv(x, a, b, k)
    assert all(torch.equal(f, s) for f, s in zip(first, second))


# ------------------------------------------------------ the BN epilogue


def bn_coefs(seed, C):
    """An eval BatchNorm's float32 (mul, add) of C channels: scales 0.25 to
    1.75, offsets of both signs (so a ReLU after it cuts)."""
    g = torch.Generator().manual_seed(seed)
    return 0.25 + 1.5 * torch.rand(C, generator=g), \
        0.5 * torch.randn(C, generator=g)


def unfused(y, mul, add, relu):
    """The model's sequence the epilogue replaces: its affine, then the
    ReLU where asked."""
    out = affine(y, mul, add, y.dtype)
    return torch.relu(out) if relu else out


@pytest.mark.parametrize("relu", [False, True], ids=["bn", "bn_relu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_epilogue_plain_equals_the_unfused_sequence(dtype, relu):
    """K2 + bn_b on the CPU: y of the wrapper, of its op and of the segment
    with autograd off (the kernel's route and ``plain_versions()``) equals
    the plain segment's y then the model's affine (then the ReLU), bit for
    bit; p and s2 stay the sums of the segment's y; the launch log names
    the epilogue and counts its work."""
    shape = (2, 5, 6, 5, 8)
    x, a, b, k = (torch.from_numpy(v) for v in _inputs(31, shape, (3, 3, 3)))
    x, k = x.to(dtype), k.to(dtype)
    mul, add = bn_coefs(32, 8)
    y, p, s2 = dw_fused.dw_bn_act_conv(x, a, b, k)
    want = unfused(y, mul, add, relu)
    with torch.no_grad(), ops.launch_log() as log:
        calls = [dw_fused.dw_bn_act_conv(x, a, b, k, mul, add, relu),
                 library.dw_bn_act_conv(x, a, b, k, mul, add, relu),
                 dw_fused.segment(x, a, b, k, mul, add, relu)]
        with plain_versions():
            calls.append(dw_fused.segment(x, a, b, k, mul, add, relu))
    for got in calls:
        assert got[0].dtype == dtype and torch.equal(got[0], want)
        assert torch.equal(got[1], p) and torch.equal(got[2], s2)
    kind = "bn_relu" if relu else "bn"
    assert [r["epilogue"] for r in log] == [kind] * 3
    work = dw_fused.fwd_cost(shape, (3, 3, 3), x.element_size())
    assert (log[0]["bytes"], log[0]["flops"]) == \
        (work[0] + 8 * 8, work[1] + (3 if relu else 2) * x.numel())


@pytest.mark.parametrize("relu", [False, True], ids=["bn", "bn_relu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_epilogue_op_passes_opcheck(dtype, relu):
    """``x3d::dw_bn_act_conv`` with the epilogue's arguments: its schema,
    and its fake's outputs against the real ones' shapes, dtypes and
    strides (``torch.library.opcheck``)."""
    x, a, b, k = (torch.from_numpy(v)
                  for v in _inputs(34, (2, 5, 7, 9, 8), (3, 3, 3)))
    mul, add = bn_coefs(35, 8)
    torch.library.opcheck(library.dw_bn_act_conv,
                          (x.to(dtype), a, b, k.to(dtype), mul, add, relu),
                          test_utils=("test_schema", "test_faketensor"))


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True], ids=["bn", "bn_relu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kdims", [
    ((3, 5, 9, 11, 70), (3, 3, 3)), ((2, 16, 14, 14, 216), (3, 3, 3)),
    ((2, 5, 9, 11, 7), (5, 3, 3)), ((2, 5, 6, 7, 6), (3, 5, 5))])
def test_epilogue_matches_the_unfused_launch_on_card(cuda, dtype, shape,
                                                     kdims, relu):
    """Each body's epilogue (ring at 3x3 spatial taps, generic at 5x5):
    y equals the same body's launch without one followed by the plain
    epilogue (``torch.addcmul``, as the model's affine), bit for bit, and p
    and s2 equal that launch's; the wrapper counts the launch under its
    kind."""
    x, a, b, k = (torch.from_numpy(v).to(cuda)
                  for v in _inputs(36, shape, kdims))
    x, k = x.to(dtype), k.to(dtype)
    C = shape[-1]
    mul, add = (v.to(cuda) for v in bn_coefs(37, C))
    body = dw_fused.segment_body(kdims)
    taps = k.float().reshape(-1, C).contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    y0, p0, s0 = dw_fused._launch_fwd(_build_lib(), body, x, a, b, taps,
                                      kdims, stream)
    y1, p1, s1 = dw_fused._launch_fwd(
        epilogue.library("dw_fused.cu", dw_fused._SIGNATURES, (mul, add)),
        body, x, a, b, taps, kdims, stream,
        epilogue.pointers((mul, add), relu))
    kind = "bn_relu" if relu else "bn"
    fn = dw_fused.dw_bn_act_conv
    before = dict(fn.epilogue_launches)
    y2 = fn(x, a, b, k, mul, add, relu)[0]
    torch.cuda.synchronize()
    assert fn.epilogue_launches == before | {kind: before[kind] + 1}
    want = epilogue.reference(y0, mul, add, relu)
    assert torch.equal(y1, want) and torch.equal(y2, want)
    assert torch.equal(p1, p0) and torch.equal(s1, s0)


def _build_lib():
    from x3d_tpu_torch.kernels import _build
    return _build.load("dw_fused.cu", dw_fused._SIGNATURES)
