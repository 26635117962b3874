"""The fused segment's backward (kernel K3) against the JAX package, and K3
against its plain version on the card.

On the CPU the backward runs its plain version.  The gradients of
``dw_fused.segment`` (dx, da, db, dk) are held against ``jax.vjp`` of the
JAX package's ``dw_fused.dw_bn_act_conv`` -- its custom VJP around the
Pallas backward kernel, in interpret mode -- with cotangents for all three
outputs (gp and gs2 nonzero), per-sample coefficient columns of both
signs of offset, and a column with a == 0, where both set da to 0 (x
cannot be recovered from u there).  Away from that column they also equal
autograd of the plain forward composition.  Tolerances (float32, sums in
another order): dx atol 1e-5; da, db rtol 1e-5 with atol 1e-4; dk rtol
1e-5 with atol 1e-4.

K3 has two bodies on the card (so has K2): :func:`dw_fused.segment_body`
sends 3x3 spatial taps with 1 to 5 temporal ones to the ring body and every
other geometry to the generic body.  The ring body's launch plan (:func:`dw_fused.bwd_plan`)
is checked here at every fused-segment shape of X3D-M and X3D-S, and its
per-(clip, tile, run) partial sums are rebuilt in numpy in the second
pass's fixed order against the plain version's sums (float32, another
order: within 1e-5 of the sums over absolute values).

JAX is imported inside the tests, so that the card tests (marker ``cuda``)
run on a machine without it:
``python -m pytest --noconftest -m cuda tests/test_torch_dw_fused_bwd.py``.
"""

import ctypes

import numpy as np
import pytest
import torch

from test_torch_dw_fused import MULTIGRID_SEGMENTS, x3d_planes
from x3d_tpu_torch import variant_config
from x3d_tpu_torch.ops import dw_fused, ring


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, shape, kdims, a_zero=True):
    rng = np.random.default_rng(seed)
    B, C = shape[0], shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    a = (0.5 + rng.uniform(size=(C, B))).astype(np.float32)
    b = (0.3 * rng.normal(size=(C, B))).astype(np.float32)
    b[0, :] = 0.4                                  # a channel all positive
    if a_zero:
        a[1, 0] = 0.0                              # the a == 0 rule
    k = (0.3 * rng.normal(size=kdims + (1, C))).astype(np.float32)
    gy = rng.normal(size=shape).astype(np.float32)
    gp = (0.1 * rng.normal(size=(C, B))).astype(np.float32)
    gs2 = (0.05 * rng.normal(size=(C, B))).astype(np.float32)
    return (x, a, b, k), (gy, gp, gs2)


def _port_grads(args, cots):
    ts = [torch.from_numpy(v).requires_grad_() for v in args]
    y, p, s2 = dw_fused.segment(*ts)
    gy, gp, gs2 = (torch.from_numpy(c) for c in cots)
    loss = (y * gy).sum() + (p * gp).sum() + (s2 * gs2).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, ts)]


def _assert_grads(got, want, mask=None):
    dx, da, db, dk = (np.asarray(w) for w in want)
    np.testing.assert_allclose(got[0], dx, rtol=0, atol=1e-5)
    m = np.ones(da.shape, bool) if mask is None else mask
    np.testing.assert_allclose(got[1][m], da[m], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[2], db, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[3], dk, rtol=1e-5, atol=1e-4)


# The interpreted Pallas kernel unrolls rows x taps x ring phases: few rows.
@pytest.mark.parametrize("shape,kdims", [
    ((3, 4, 2, 5, 7), (3, 3, 3)), ((2, 5, 4, 9, 3), (3, 1, 1))])
def test_matches_jax_pallas_vjp(shape, kdims):
    import jax
    from x3d_tpu.ops import dw_fused as jax_dw_fused

    args, cots = _inputs(0, shape, kdims)
    old = jax_dw_fused.INTERPRET
    jax_dw_fused.INTERPRET = True
    try:
        _, vjp = jax.vjp(jax_dw_fused.dw_bn_act_conv, *args)
        want = jax.jit(vjp)(cots)
    finally:
        jax_dw_fused.INTERPRET = old
    got = _port_grads(args, cots)
    assert got[1][1, 0] == 0.0 and np.asarray(want[1])[1, 0] == 0.0
    _assert_grads(got, want)


@pytest.mark.parametrize("shape,kdims", [
    ((3, 5, 6, 5, 7), (3, 3, 3)), ((2, 5, 4, 9, 3), (5, 3, 3)),
    # fewer frames than taps: multigrid's coarse phases (X3D-XS 1, 2)
    ((2, 1, 6, 5, 7), (3, 3, 3)), ((2, 2, 4, 9, 3), (3, 3, 3))])
def test_matches_autograd_of_the_composition(shape, kdims):
    """Against jax.vjp of the plain composition ``dw_fused.reference``: the
    true gradients, equal to the kernel rule's wherever a != 0."""
    import jax
    from x3d_tpu.ops import dw_fused as jax_dw_fused

    args, cots = _inputs(1, shape, kdims)
    _, vjp = jax.vjp(jax_dw_fused.reference, *args)
    want = vjp(cots)
    got = _port_grads(args, cots)
    _assert_grads(got, want, mask=args[1] != 0)


def test_unused_outputs_count_as_zero():
    """In training s2's cotangent may be absent (None); it counts as 0."""
    args, cots = _inputs(2, (2, 4, 5, 6, 3), (3, 3, 3), a_zero=False)
    ts = [torch.from_numpy(v).requires_grad_() for v in args]
    y, p, _ = dw_fused.segment(*ts)
    gy, gp = torch.from_numpy(cots[0]), torch.from_numpy(cots[1])
    got = torch.autograd.grad((y * gy).sum() + (p * gp).sum(), ts)
    want = _port_grads(args, (cots[0], cots[1], np.zeros_like(cots[2])))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_bwd_wrapper_equals_plain_version():
    args, cots = _inputs(3, (2, 4, 5, 6, 3), (3, 3, 3))
    t = [torch.from_numpy(v) for v in args]
    y = dw_fused.reference(*t)[0]
    c = [torch.from_numpy(v) for v in cots]
    got = dw_fused.dw_bn_act_conv_bwd(*t, y, *c)
    want = dw_fused.bwd_reference(*t, y, *c)
    assert got[1].shape == (3, 3, 3, 1, 3) and got[2].shape == (3, 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("kt", [1, 2, 3, 4, 5])
def test_bwd_body_takes_ring_at_3x3_taps(kt):
    assert dw_fused.segment_body((kt, 3, 3)) == "ring"


@pytest.mark.parametrize("kdims", [(3, 5, 5), (3, 1, 1), (5, 1, 1),
                                   (7, 3, 3), (3, 3, 5), (1, 1, 1)])
def test_bwd_body_takes_generic_elsewhere(kdims):
    assert dw_fused.segment_body(kdims) == "generic"


# The fused segments' (B, T, H, W, C) in training: X3D-M (32 clips of 16
# frames; stages 2-5 at 56², 28², 14², 7²) and X3D-S (64 clips of 13 frames;
# 40², 20², 10², 5²)
SEGMENTS = [(32, 16, 56, 56, 54), (32, 16, 28, 28, 108),
            (32, 16, 14, 14, 216), (32, 16, 7, 7, 432),
            (64, 13, 40, 40, 54), (64, 13, 20, 20, 108),
            (64, 13, 10, 10, 216), (64, 13, 5, 5, 432)]
SEGMENT_IDS = ["M2", "M3", "M4", "M5", "S2", "S3", "S4", "S5"]
# X3D-XS, -L and -XL at their training batches (128, 16, 16 clips)
NEW_SEGMENTS = [(f"{v}{st}", (variant_config(v).TRAIN.BATCH_SIZE, *seg))
                for v in ("XS", "L", "XL")
                for st, _, seg in x3d_planes(v, True)]


@pytest.mark.parametrize("shape", SEGMENTS + [s for _, s in NEW_SEGMENTS]
                         + [s for s, _ in MULTIGRID_SEGMENTS],
                         ids=SEGMENT_IDS + [i for i, _ in NEW_SEGMENTS]
                         + [i for _, i in MULTIGRID_SEGMENTS])
@pytest.mark.parametrize("elem,align", [(2, 16), (2, 2), (4, 16), (4, 4),
                                        (2, 8)])
@pytest.mark.parametrize("slots", [0, 132, 264])
def test_ring_plan_covers_the_clip(shape, elem, align, slots):
    """Tiles cover each plane, each frame lies in exactly one run, every
    channel group starts on a copy granule (a cell of two channels where the
    addresses allow), and the block fits the card."""
    B, T, H, W, C = shape
    p = dw_fused.bwd_plan(B, T, H, W, C, 3, elem, align, slots)
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
    role = p["group"] // vec * p["rows"]              # du and dk roles
    assert role <= ring.RING_MAX_THREADS
    assert p["threads"] == 2 * -(-role // 32) * 32
    assert p["smem_bytes"] <= dw_fused.RING_SMEM
    assert 0 <= p["vec_pad"] < 32
    assert 0 <= p["row_cells"] - (p["tile_w"] + 2 + p["tile_w"] % 2) < 8
    assert p["parts"] == B * p["tiles_h"] * p["tiles_w"] * p["runs"]
    blocks = p["groups"] * p["tiles_h"] * p["tiles_w"] * B
    if p["runs"] > 1:
        assert blocks * (p["runs"] - 1) < 2 * slots


def test_ring_partials_rebuild_the_sums():
    """dk, dzs and duu from per-(clip, tile, run) partials over the plan's
    tiles and runs, summed as the second pass sums them (lane y of 16 takes
    partials y, y + 16, ... in double, then the lanes in order), equal the
    plain version's sums."""
    shape, kt = (2, 9, 6, 17, 5), 3
    B, T, H, W, C = shape
    p = dw_fused.bwd_plan(B, T, H, W, C, kt, 4, 16, 1000)
    assert p["runs"] > 1 and p["tiles_w"] > 1
    args, cots = _inputs(8, shape, (kt, 3, 3))
    t = [torch.from_numpy(v) for v in args]
    y = dw_fused.reference(*t)[0]
    c = [torch.from_numpy(v) for v in cots]
    want = dw_fused.bwd_reference(*t, y, *c)
    scales = dw_fused.bwd_abs_sums(*t, y, *c)
    u = dw_fused._relu_affine(t[0], t[1], t[2]).numpy()
    g = dw_fused._g_eff(c[0], c[1], c[2], y).numpy()
    du = dw_fused.depthwise_conv3d_reference(
        torch.from_numpy(g), t[3].flip(0, 1, 2), (1, 1, 1),
        dw_fused._same(T, H, W, kt, 3, 3)).numpy()
    dz = np.where(u > 0, du, 0.0).astype(np.float32)
    upad = np.pad(u, ((0, 0), (1, 1), (1, 1), (1, 1), (0, 0)))
    part_dk, part_s, part_u = [], [], []    # (clip, tile, run), as laid out
    for b in range(B):
        for th in range(p["tiles_h"]):
            for tw in range(p["tiles_w"]):
                for r in range(p["runs"]):
                    ts = slice(r * p["run"], min((r + 1) * p["run"], T))
                    hs = slice(th * p["tile_h"], (th + 1) * p["tile_h"])
                    ws = slice(tw * p["tile_w"], (tw + 1) * p["tile_w"])
                    gt = g[b, ts, hs, ws]
                    nt, nh, nw = gt.shape[:3]
                    t0, h0, w0 = ts.start, hs.start, ws.start
                    part_dk.append(np.stack([
                        (upad[b, t0 + dt:t0 + dt + nt, h0 + dh:h0 + dh + nh,
                              w0 + dw:w0 + dw + nw] * gt).sum((0, 1, 2))
                        for dt in range(kt) for dh in range(3)
                        for dw in range(3)]).astype(np.float32))
                    dzt = dz[b, ts, hs, ws]
                    part_s.append((b, dzt.sum((0, 1, 2))))
                    part_u.append((b, (dzt * u[b, ts, hs, ws]).sum((0, 1, 2))))

    def second_pass(parts):
        lanes = [np.sum([parts[k].astype(np.float64)
                         for k in range(y_, len(parts), 16)], axis=0)
                 if y_ < len(parts) else 0.0 for y_ in range(16)]
        total = np.zeros_like(parts[0], dtype=np.float64)
        for lane in lanes:
            total = total + lane
        return total.astype(np.float32)

    dk = second_pass(part_dk).reshape(kt, 3, 3, 1, C)
    dzs = np.stack([second_pass([v for bb, v in part_s if bb == b])
                    for b in range(B)], axis=1)
    duu = np.stack([second_pass([v for bb, v in part_u if bb == b])
                    for b in range(B)], axis=1)
    for got, w, s in zip((dk, dzs, duu), want[1:], scales):
        assert np.all(np.abs(got - w.numpy()) <= 1e-5 * s.numpy() + 1e-6)


class _FailingLibrary:
    """A K3 library whose ring body fails at launch; it records the calls."""

    def __init__(self):
        self.calls = []

    def x3d_dw_bn_act_conv_bwd_ring_occupancy(self, *args):
        self.calls.append("occupancy")
        ctypes.cast(args[-1], ctypes.POINTER(ctypes.c_int * 2)).contents[:] \
            = [1, 132]
        return 0

    def x3d_dw_bn_act_conv_bwd_ring(self, *args):
        self.calls.append("ring")
        return 1                                   # cudaErrorInvalidValue

    def __getattr__(self, name):                   # the generic body's
        raise AssertionError(f"fell back to {name}")


def test_failed_ring_launch_raises_without_fallback():
    """A ring-body launch that returns an error raises; the generic body
    is never asked to take over."""
    args, cots = _inputs(9, (2, 5, 6, 6, 8), (3, 3, 3))
    x, a, b, k = (torch.from_numpy(v) for v in args)
    gy, gp, gs2 = (torch.from_numpy(v) for v in cots)
    y = dw_fused.reference(x, a, b, k)[0]
    lib = _FailingLibrary()
    ring._slots.clear()
    with pytest.raises(RuntimeError, match=r"ring body.*CUDA error 1"):
        dw_fused._launch_bwd(lib, "ring", x, [a, b, gp, gs2],
                             k.reshape(27, 8).contiguous(), y, gy,
                             (3, 3, 3), 0)
    ring._slots.clear()
    assert lib.calls == ["occupancy", "ring"]


def test_non_cpu_tensor_never_falls_back():
    args, cots = _inputs(4, (2, 3, 4, 4, 4), (3, 3, 3))
    t = [torch.from_numpy(v).to("meta") for v in args + cots]
    x, a, b, k, gy, gp, gs2 = t
    with pytest.raises(ValueError, match="CUDA"):
        dw_fused.dw_bn_act_conv_bwd(x, a, b, k, x, gy, gp, gs2)


def _card_inputs(seed, shape, kdims, cuda, dtype):
    args, cots = _inputs(seed, shape, kdims)
    x, a, b, k = (torch.from_numpy(v).to(cuda) for v in args)
    gy, gp, gs2 = (torch.from_numpy(v).to(cuda) for v in cots)
    x, k, gy = x.to(dtype), k.to(dtype), gy.to(dtype)
    return x, a, b, k, dw_fused.reference(x, a, b, k)[0], gy, gp, gs2


def _assert_matches_plain(got, inputs, dtype):
    want = dw_fused.bwd_reference(*inputs)
    tol_dx = 1e-4 if dtype == torch.float32 else \
        2e-2 * want[0].float().abs().max().item()
    assert got[0].dtype == dtype
    assert (got[0].float() - want[0].float()).abs().max().item() <= tol_dx
    for g, w, s in zip(got[1:], want[1:], dw_fused.bwd_abs_sums(*inputs)):
        assert ((g - w).abs() <= 1e-5 * s + 1e-6).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kdims", [
    ((3, 5, 6, 5, 7), (3, 3, 3)), ((2, 5, 4, 9, 3), (5, 3, 3)),
    ((3, 6, 9, 17, 70), (3, 3, 3)), ((2, 16, 7, 7, 432), (3, 3, 3)),
    ((2, 8, 10, 10, 7), (5, 3, 3)), ((2, 7, 9, 11, 70), (5, 3, 3)),
    ((2, 5, 8, 8, 6), (1, 3, 3)), ((2, 5, 6, 7, 6), (3, 5, 5)),
    # fewer frames than temporal taps (multigrid's coarse phases)
    ((2, 1, 6, 5, 7), (3, 3, 3)), ((2, 2, 4, 9, 3), (3, 3, 3)),
    ((2, 1, 7, 7, 432), (3, 3, 3)), ((2, 2, 9, 11, 70), (5, 3, 3)),
    ((2, 3, 8, 9, 70), (5, 3, 3)), ((2, 2, 6, 7, 6), (3, 5, 5))] + [
    ((2, *s[1:]), (3, 3, 3)) for s in SEGMENTS])
def test_kernel_matches_plain_on_card(cuda, dtype, shape, kdims):
    """The plain version on the same inputs rounds u and g to x's dtype as
    the kernel does and sums in float32 (cuDNN, TF32 off), so the two differ
    by the order of the sums: dk, dzs, duu within 1e-5 of the matching sums
    of absolute values; dx atol 1e-4 in float32, and in bfloat16 within
    2e-2 of its largest |dx| (one rounding of dx).  3x3 spatial taps run the
    ring body (every X3D-M and X3D-S segment shape at 2 clips), 5x5 the
    generic body, and the counters say which."""
    inputs = _card_inputs(5, shape, kdims, cuda, dtype)
    body = "ring" if kdims[1:] == (3, 3) else "generic"
    assert dw_fused.segment_body(kdims) == body
    fn = dw_fused.dw_bn_act_conv_bwd
    before = (fn.launches, dict(fn.body_launches))
    got = fn(*inputs)
    torch.cuda.synchronize()
    assert fn.launches == before[0] + 1
    assert fn.body_launches == before[1] | {body: before[1][body] + 1}
    _assert_matches_plain(got, inputs, dtype)


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
    """x, y and gy starting 2 to 16 bytes into their allocations: the copy
    granule shrinks to what the addresses allow; results as above."""
    x, a, b, k, y, gy, gp, gs2 = _card_inputs(6, shape, (3, 3, 3), cuda,
                                              dtype)
    x, y, gy = (_on_card_at(t, offset) for t in (x, y, gy))
    assert x.data_ptr() % 32 == offset % 32
    inputs = (x, a, b, k, y, gy, gp, gs2)
    _assert_matches_plain(dw_fused.dw_bn_act_conv_bwd(*inputs), inputs,
                          dtype)


@pytest.mark.cuda
def test_failed_ring_launch_raises_on_card(cuda, monkeypatch):
    """A plan the ring body cannot run (no thread rows) makes its launch
    fail: the call raises and counts no launch; nothing else runs it."""
    inputs = _card_inputs(9, (2, 5, 6, 6, 8), (3, 3, 3), cuda,
                          torch.bfloat16)
    plan = dw_fused._ring_plan
    monkeypatch.setattr(dw_fused, "_ring_plan",
                        lambda *args: plan(*args) | {"rows": 0})
    fn = dw_fused.dw_bn_act_conv_bwd
    before = (fn.launches, dict(fn.body_launches))
    with pytest.raises(RuntimeError, match="ring body"):
        fn(*inputs)
    assert (fn.launches, fn.body_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SEGMENTS, ids=SEGMENT_IDS)
def test_ring_body_repeats_bit_for_bit(cuda, shape):
    """No atomics: dx is written once and the sums are taken in a fixed
    order, so bfloat16 calls on one input give equal bits, at the full
    training batch."""
    inputs = _card_inputs(7, shape, (3, 3, 3), cuda, torch.bfloat16)
    first = dw_fused.dw_bn_act_conv_bwd(*inputs)
    second = dw_fused.dw_bn_act_conv_bwd(*inputs)
    assert all(torch.equal(f, s) for f, s in zip(first, second))
