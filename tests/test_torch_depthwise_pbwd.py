"""The depthwise conv's one-pass backward (kernel K8: du and dk from one
stream over the input and the cotangent) against the JAX package, its
dispatch, and K8 against its plain version and against K4 on the card.

On the CPU the wrapper runs its plain version (K4's two plain versions).
It is held against ``jax.vjp`` of the JAX package's ``dw_fused.dw_conv_pbwd``
-- the library forward with the one-pass Pallas backward ``_pbwd_kernel`` --
in interpret mode, for 3x3x3 and 5x3x3 taps and the stem's 5x1x1.
Tolerances (float32, sums in another order): du atol 1e-5; dk rtol 1e-5
with atol 1e-4 (sums of a few hundred products of order 1).

The dispatch: ``depthwise`` (the model's op) takes the one-pass backward
where both gradients are wanted and the conv has stride 1, SAME pads, odd
taps and at least as many frames as temporal taps; stride 2, other pads and
even taps keep K4's two entry points.  K8 has two bodies: the temporal body
for 1x1 spatial taps (every X3D stem but XS's, which has fewer frames than
taps and stays on K4) and the generic body for the rest.  Its launch plan
is pure Python and checked here; its order of sums is rebuilt in numpy and
held against the plain version.

JAX is imported inside the tests, so that the card tests (marker ``cuda``)
run on a machine without it:
``python -m pytest --noconftest -m cuda tests/test_torch_depthwise_pbwd.py``.
"""

import ctypes

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from x3d_tpu_torch import variant_config
from x3d_tpu_torch.models import build_arch
from x3d_tpu_torch.ops import depthwise, ring

KDIMS = [(3, 3, 3), (5, 3, 3), (5, 1, 1)]


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
    u = rng.normal(size=shape).astype(np.float32)
    k = (0.3 * rng.normal(size=tuple(kdims) + (1, shape[-1]))
         ).astype(np.float32)
    gy = rng.normal(size=shape).astype(np.float32)
    return u, gy, k


@pytest.mark.parametrize("kdims", KDIMS, ids=str)
def test_matches_jax_one_pass_backward_interpret(kdims):
    import jax
    from x3d_tpu.ops import dw_fused

    # a small clip: the interpreter's time goes into tracing the unrolled
    # taps, a minute for 5x3x3 whatever the shape
    u, gy, k = _inputs(0, (2, 5, 4, 3, 4), kdims)
    old = dw_fused.INTERPRET
    dw_fused.INTERPRET = True
    try:
        want_du, want_dk = jax.jit(
            lambda u, k, gy: jax.vjp(dw_fused.dw_conv_pbwd, u, k)[1](gy))(
                u, k, gy)
    finally:
        dw_fused.INTERPRET = old
    du, dk = depthwise.depthwise_conv3d_pbwd(*map(torch.from_numpy,
                                                  (u, gy, k)))
    assert dk.shape == k.shape and dk.dtype == torch.float32
    np.testing.assert_allclose(du.numpy(), np.asarray(want_du), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(dk.numpy(), np.asarray(want_dk), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("shape,kdims,strides,padding,want", [
    ((2, 5, 8, 8, 3), (3, 3, 3), (1, 1, 1), "SAME", True),
    ((2, 6, 5, 4, 3), (5, 1, 1), (1, 1, 1), ((2, 2), (0, 0), (0, 0)), True),
    ((2, 5, 8, 8, 3), (3, 3, 3), (1, 2, 2), "SAME", False),    # stride 2
    ((2, 5, 8, 8, 3), (3, 3, 3), (1, 1, 1), "VALID", False),   # not SAME
    ((2, 5, 8, 8, 3), (3, 3, 3), (1, 1, 1),
     ((1, 1), (2, 0), (1, 1)), False),                         # lopsided
    ((2, 5, 8, 8, 3), (2, 3, 3), (1, 1, 1), "SAME", False),    # even taps
    ((2, 3, 8, 8, 3), (5, 3, 3), (1, 1, 1), "SAME", False),    # T < kt
], ids=["stride1", "stem5x1x1", "stride2", "valid", "lopsided", "even_taps",
        "few_frames"])
def test_dispatch(monkeypatch, shape, kdims, strides, padding, want):
    """Which backward ``depthwise`` takes, and that both give the plain
    conv's gradients."""
    taken = []
    for name in ("depthwise_conv3d_pbwd", "depthwise_conv3d_dx",
                 "depthwise_conv3d_dk"):
        def spy(*args, _real=getattr(depthwise, name), _name=name):
            taken.append(_name)
            return _real(*args)
        monkeypatch.setattr(depthwise, name, spy)

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    k = torch.from_numpy((0.3 * rng.normal(size=kdims + (1, shape[-1])))
                         .astype(np.float32))
    pads = depthwise._resolve_pads(shape, kdims, strides, padding)
    assert depthwise.pbwd_eligible(shape, kdims, strides, pads) is want

    xt, kt = x.clone().requires_grad_(), k.clone().requires_grad_()
    y = depthwise.depthwise(xt, kt, strides, padding)
    g = torch.from_numpy(rng.normal(size=tuple(y.shape)).astype(np.float32))
    gx, gk = torch.autograd.grad(y, (xt, kt), g)
    assert taken == (["depthwise_conv3d_pbwd"] if want else
                     ["depthwise_conv3d_dx", "depthwise_conv3d_dk"])

    xr, kr = x.clone().requires_grad_(), k.clone().requires_grad_()
    yr = depthwise.depthwise_conv3d_reference(xr, kr, strides, pads)
    rx, rk = torch.autograd.grad(yr, (xr, kr), g)
    np.testing.assert_allclose(gx.numpy(), rx.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(gk.numpy(), rk.numpy(), rtol=1e-5, atol=1e-4)


def test_one_gradient_alone_keeps_k4(monkeypatch):
    """The one-pass backward computes both gradients; where only one is
    wanted (frozen taps) the single K4 entry point runs."""
    taken = []
    for name in ("depthwise_conv3d_pbwd", "depthwise_conv3d_dx",
                 "depthwise_conv3d_dk"):
        def spy(*args, _real=getattr(depthwise, name), _name=name):
            taken.append(_name)
            return _real(*args)
        monkeypatch.setattr(depthwise, name, spy)
    u, gy, k = map(torch.from_numpy, _inputs(2, (2, 4, 6, 6, 3), (3, 3, 3)))
    u.requires_grad_()
    y = depthwise.depthwise(u, k)
    (du,) = torch.autograd.grad(y, (u,), gy)
    assert taken == ["depthwise_conv3d_dx"] and du.shape == u.shape


def test_arguments_are_checked():
    u, gy, k = map(torch.from_numpy, _inputs(3, (2, 4, 6, 6, 3), (3, 3, 3)))
    with pytest.raises(ValueError, match="cotangent"):
        depthwise.depthwise_conv3d_pbwd(u, gy[:, :, :-1], k)
    with pytest.raises(TypeError, match="cotangent"):
        depthwise.depthwise_conv3d_pbwd(u, gy.bfloat16(), k)
    with pytest.raises(ValueError, match="odd taps"):
        depthwise.depthwise_conv3d_pbwd(u, gy, k[:2])
    with pytest.raises(ValueError, match="odd taps"):                # T < kt
        depthwise.depthwise_conv3d_pbwd(
            u, gy, torch.zeros(5, 3, 3, 1, 3))


def test_non_cpu_tensor_never_falls_back():
    u, gy, k = (torch.from_numpy(a).to("meta")
                for a in _inputs(3, (2, 4, 6, 6, 3), (3, 3, 3)))
    with pytest.raises(ValueError, match="CUDA"):
        depthwise.depthwise_conv3d_pbwd(u, gy, k)


# ------------------------------------------- K8's bodies and their plan

VARIANTS = ("XS", "S", "M", "L", "XL")


def _stem(variant):
    """(shape, kdims, pads) of a variant's stem conv_t at its training
    batch and crop, from its YAML's architecture plan."""
    cfg = variant_config(variant)
    arch = build_arch(cfg)
    S = cfg.DATA.TRAIN_CROP_SIZE // 2
    shape = (cfg.TRAIN.BATCH_SIZE, cfg.DATA.TEMP_DURATION, S, S,
             arch.conv1_dim)
    kdims = (arch.temp_filter, 1, 1)
    return shape, kdims, depthwise._resolve_pads(shape, kdims, (1, 1, 1),
                                                 "SAME")


@pytest.mark.parametrize("variant", VARIANTS)
def test_pbwd_body_rule_at_the_stems(variant):
    """Every X3D stem takes the temporal body but XS's, whose 4 frames are
    fewer than its 5 taps: its backward stays on K4."""
    shape, kdims, pads = _stem(variant)
    assert kdims == (5, 1, 1)
    eligible = depthwise.pbwd_eligible(shape, kdims, (1, 1, 1), pads)
    assert eligible is (variant != "XS")
    assert depthwise.pbwd_body(kdims, pads) == "temporal"


@pytest.mark.parametrize("shape,kdims,want", [
    ((2, 5, 8, 8, 3), (3, 3, 3), "generic"),
    ((2, 5, 8, 8, 3), (5, 3, 3), "generic"),
    ((2, 5, 8, 8, 3), (5, 3, 1), "generic"),
    ((2, 5, 8, 8, 3), (1, 3, 3), "generic"),
    ((2, 5, 8, 8, 3), (1, 1, 1), "temporal"),
    ((2, 5, 8, 8, 3), (3, 1, 1), "temporal"),
    ((2, 7, 8, 8, 3), (7, 1, 1), "generic"),      # kt past RING_MAX_KT
], ids=str)
def test_pbwd_body_rule(shape, kdims, want):
    pads = depthwise._resolve_pads(shape, kdims, (1, 1, 1), "SAME")
    assert depthwise.pbwd_eligible(shape, kdims, (1, 1, 1), pads)
    assert depthwise.pbwd_body(kdims, pads) == want
    # lopsided pads are not SAME: never the temporal body
    assert depthwise.pbwd_body(kdims, ((0, kdims[0] - 1), (0, 0),
                                       (0, 0))) == (
        "temporal" if kdims == (1, 1, 1) else "generic")


def _check_plan(p, B, T, H, W, C, kt, elem, align, slots):
    N = B * H * W
    vec, group, pixels = p["vec"], p["group"], p["pixels"]
    cells = C // vec
    # the cell: divides C, honours the addresses, the widest allowed
    assert C % vec == 0 and align % (vec * elem) == 0
    assert p["cell_bytes"] == vec * elem <= depthwise.PBWD_MAX_CELL
    wider = [w // elem for w in (8, 4) if vec * elem < w
             <= depthwise.PBWD_MAX_CELL]
    assert not any(v >= 1 and C % v == 0 and align % (v * elem) == 0
                   for v in wider)
    # threads (cell, pixel): the groups cover a pixel's cells
    assert p["threads"] == group * pixels <= depthwise.PBWD_THREADS
    assert p["threads"] % group == 0
    assert p["groups"] * group >= cells > (p["groups"] - 1) * group
    if p["groups"] == 1:
        assert group == cells                       # threads % (C / vec)
    assert pixels == depthwise.PBWD_THREADS // group
    # the blocks' pixel rows cover the clip's pixels, each once
    rows = -(-N // pixels)
    assert p["pblocks"] * p["walk"] >= rows > (p["pblocks"] - 1) * p["walk"]
    # the runs cover the frames
    assert p["runs"] * p["run"] >= T > (p["runs"] - 1) * p["run"]
    assert p["run"] >= min(T, ring.RING_MIN_RUN)
    if slots == 0:
        assert p["runs"] == 1
    # one partial a block and channel group; the walk is the shortest that
    # keeps them at PBWD_MAX_PARTS
    assert p["parts"] == p["pblocks"] * p["runs"]
    assert p["blocks"] == p["parts"] * p["groups"]
    assert p["parts"] <= depthwise.PBWD_MAX_PARTS or p["walk"] == rows
    if p["walk"] > 1:
        assert -(-rows // (p["walk"] - 1)) * p["runs"] > \
            depthwise.PBWD_MAX_PARTS
    assert p["smem_bytes"] == p["threads"] * kt * vec * 4


@settings(max_examples=150, deadline=None, database=None)
@given(B=st.integers(1, 64), T=st.integers(1, 20), H=st.integers(1, 120),
       W=st.integers(1, 120), C=st.integers(1, 2500),
       kt=st.sampled_from([1, 3, 5]), elem=st.sampled_from([2, 4]),
       align=st.sampled_from([2, 4, 8, 16]),
       slots=st.sampled_from([0, 33792, 270336]))
def test_pbwd_temporal_plan_invariants(B, T, H, W, C, kt, elem, align, slots):
    align = max(align, elem)
    p = depthwise.pbwd_temporal_plan(B, T, H, W, C, kt, elem, align, slots)
    _check_plan(p, B, T, H, W, C, kt, elem, align, slots)


@pytest.mark.parametrize("variant", VARIANTS)
def test_pbwd_temporal_plan_at_the_stems(variant):
    """At every stem (C = 24, XL's 32, in bfloat16): 8-byte cells of 4
    channels, C / 4 cells a pixel, blocks of C / 4 x (256 // (C / 4))
    threads, one run of all the frames, each block walking the fewest pixel
    rows that keep the partials at PBWD_MAX_PARTS (on a card of 132 SMs
    holding 512 threads each)."""
    shape, kdims, _ = _stem(variant)
    B, T, H, W, C = shape
    assert C == (32 if variant == "XL" else 24)
    p = depthwise.pbwd_temporal_plan(*shape, kdims[0], 2, 16, 132 * 512)
    _check_plan(p, *shape, kdims[0], 2, 16, 132 * 512)
    pixels = 256 // (C // 4)
    assert (p["vec"], p["group"], p["pixels"], p["runs"]) == \
        (4, C // 4, pixels, 1)
    rows = -(-B * H * W // pixels)
    assert p["walk"] == max(1, -(-rows // depthwise.PBWD_MAX_PARTS))


def _pbwd_by_temporal_order(u, gy, k, plan):
    """du and dk rebuilt in numpy in the temporal body's order of sums, for
    a plan of one channel group: du[t] = sum over i ascending of gy[t - lo +
    i] k[kt - 1 - i] in float32; each thread (cell, pixel row) sums dk[i] +=
    u[t - lo + i] gy[t] in float32 over its walk's pixels, then its run's
    frames; a block adds its rows in order, in double, into one float32
    partial (row pixel block x runs + run); the second pass adds the
    partials in kSumLanes (16) interleaved chunks in double, then the
    chunks in order."""
    B, T, H, W, C = u.shape
    kt = k.shape[0]
    lo = kt // 2
    assert plan["groups"] == 1
    N, pixels, walk, run = B * H * W, plan["pixels"], plan["walk"], \
        plan["run"]
    uf = u.reshape(B, T, H * W, C).transpose(0, 2, 1, 3).reshape(N, T, C)
    gf = gy.reshape(B, T, H * W, C).transpose(0, 2, 1, 3).reshape(N, T, C)
    zeros = np.zeros((N, lo, C), np.float32)
    up, gp = (np.concatenate([zeros, a, zeros], 1) for a in (uf, gf))
    kk = k.reshape(kt, C)
    du = np.zeros((N, T, C), np.float32)
    for i in range(kt):
        du += gp[:, i:i + T] * kk[kt - 1 - i]
    part = np.zeros((plan["parts"], kt, C), np.float32)
    for pb in range(plan["pblocks"]):
        for r in range(plan["runs"]):
            t0, t1 = r * run, min((r + 1) * run, T)
            rows = np.zeros((pixels, kt, C), np.float32)
            for it in range(walk):
                p0 = (pb * walk + it) * pixels
                p1 = min(p0 + pixels, N)
                if p0 >= N:
                    break
                for t in range(t0, t1):
                    for i in range(kt):
                        rows[:p1 - p0, i] += up[p0:p1, t + i] * \
                            gp[p0:p1, t + lo]
            part[pb * plan["runs"] + r] = \
                rows.astype(np.float64).sum(0).astype(np.float32)
    lanes = [part[y::16].astype(np.float64).sum(0) for y in range(16)]
    dk = np.zeros((kt, C), np.float64)
    for lane in lanes:
        dk += lane
    du = du.reshape(B, H * W, T, C).transpose(0, 2, 1, 3).reshape(u.shape)
    return du, dk.astype(np.float32).reshape(k.shape)


@pytest.mark.parametrize("shape,kt,slots,max_parts", [
    ((2, 5, 3, 3, 24), 5, 0, 4096),
    ((2, 6, 7, 5, 40), 5, 0, 4096),
    ((1, 13, 4, 4, 24), 5, 10 ** 6, 4096),       # runs cut
    ((3, 5, 10, 11, 24), 3, 0, 3),               # blocks walk pixel rows
    ((2, 4, 9, 7, 3), 3, 0, 1),
    ((1, 4, 2, 3, 33), 1, 0, 4096),
], ids=["stem", "ragged", "runs", "walk", "odd_C", "kt1"])
def test_temporal_order_of_sums_rebuilds_pbwd(monkeypatch, shape, kt, slots,
                                              max_parts):
    monkeypatch.setattr(depthwise, "PBWD_MAX_PARTS", max_parts)
    depthwise.pbwd_temporal_plan.cache_clear()
    try:
        plan = depthwise.pbwd_temporal_plan(*shape, kt, 4, 16, slots)
    finally:
        depthwise.pbwd_temporal_plan.cache_clear()
    assert (plan["runs"] > 1) == (slots > 0)
    assert (plan["walk"] > 1) == (max_parts < 10)
    u, gy, k = _inputs(5, shape, (kt, 1, 1))
    du, dk = _pbwd_by_temporal_order(u, gy, k, plan)
    want_du, want_dk = depthwise.depthwise_conv3d_pbwd_reference(
        *map(torch.from_numpy, (u, gy, k)))
    np.testing.assert_allclose(du, want_du.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dk, want_dk.numpy(), rtol=1e-5, atol=1e-4)


class _FailingLibrary:
    """A K8 library whose temporal body fails at launch; it records the
    calls."""

    def __init__(self):
        self.calls = []

    def x3d_dw_conv3d_pbwd_temporal_occupancy(self, *args):
        self.calls.append("temporal occupancy")
        ctypes.cast(args[-1], ctypes.POINTER(ctypes.c_int * 2)).contents[:] \
            = [2, 132]
        return 0

    def x3d_dw_conv3d_pbwd_temporal(self, *args):
        self.calls.append("temporal")
        return 1                                   # cudaErrorInvalidValue

    def __getattr__(self, name):                   # the generic body's
        raise AssertionError(f"fell back to {name}")


def test_failed_temporal_launch_raises_without_fallback():
    """A temporal-body launch that returns an error raises; neither the
    generic body nor the plain version takes over."""
    u, gy, k = map(torch.from_numpy, _inputs(9, (2, 5, 3, 3, 8), (5, 1, 1)))
    lib = _FailingLibrary()
    ring._slots.clear()
    with pytest.raises(RuntimeError, match=r"temporal body.*CUDA error 1"):
        depthwise._launch_pbwd(lib, "temporal", u, gy,
                               k.reshape(5, 8).contiguous(), (5, 1, 1), 0)
    ring._slots.clear()
    assert lib.calls == ["temporal occupancy", "temporal"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kdims", [
    ((3, 5, 6, 5, 4), (3, 3, 3)), ((3, 5, 6, 5, 4), (5, 3, 3)),
    ((3, 13, 20, 20, 24), (5, 1, 1)), ((2, 13, 21, 19, 54), (3, 3, 3)),
    ((2, 4, 9, 10, 40), (1, 3, 3)), ((2, 5, 8, 8, 33), (5, 3, 1)),
    ((2, 16, 12, 12, 24), (5, 1, 1)), ((1, 3, 1, 1, 1), (3, 1, 1))])
def test_kernel_matches_plain_and_k4_on_card(cuda, dtype, shape, kdims):
    """float32: du atol 1e-4, dk within 1e-5 of the sum of |u gy| for each
    (tap, channel); bfloat16 against the plain version in float32 on the
    same bfloat16 inputs: du 2e-2 of the largest |du|, dk 1e-4 of the
    |u gy| sums.  Against K4's dx and dk on the same inputs: du within one
    rounding of the output (the taps are summed in another order), dk
    within 1e-6 of the |u gy| sums."""
    u, gy, k = (torch.from_numpy(a).to(cuda).to(dtype)
                for a in _inputs(4, shape, kdims))
    pads = depthwise._resolve_pads(shape, kdims, (1, 1, 1), "SAME")
    body = depthwise.pbwd_body(kdims, pads)
    assert body == ("temporal" if kdims[1:] == (1, 1) else "generic")
    fn = depthwise.depthwise_conv3d_pbwd
    before, bodies = fn.launches, dict(fn.body_launches)
    du, dk = fn(u, gy, k)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    bodies[body] += 1
    assert fn.body_launches == bodies
    rdu, rdk = depthwise.depthwise_conv3d_pbwd_reference(
        u.float(), gy.float(), k.float())
    scale = depthwise.depthwise_conv3d_dk_reference(
        u.float().abs(), gy.float().abs(), kdims, (1, 1, 1), pads)
    tol_du, tol_dk = (1e-4, 1e-5) if dtype == torch.float32 else \
        (2e-2 * rdu.abs().max().item(), 1e-4)
    assert du.dtype == dtype and dk.dtype == torch.float32
    assert dk.shape == k.shape
    assert (du.float() - rdu).abs().max().item() <= tol_du
    assert ((dk - rdk).abs() <= tol_dk * scale + 1e-6).all()

    dx4 = depthwise.depthwise_conv3d_dx(gy, k, u.shape, (1, 1, 1), pads)
    dk4 = depthwise.depthwise_conv3d_dk(u, gy, kdims, (1, 1, 1), pads)
    ulp = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert ((du.float() - dx4.float()).abs()
            <= ulp * rdu.abs().clamp_min(1.0)).all()
    assert ((dk - dk4).abs() <= 1e-6 * scale + 1e-6).all()


# ------------------------------------------------ the temporal body, on card

def _on_card(cuda, dtype, shape, kdims, seed, offset=0):
    """u, gy and k on the card; u and gy start ``offset`` elements into
    their allocations."""
    u, gy, k = _inputs(seed, shape, kdims)
    n = u.size

    def placed(a):
        buf = torch.zeros(n + 16, dtype=dtype, device=cuda)
        buf[offset:offset + n] = torch.from_numpy(a.ravel()).to(cuda)
        return buf[offset:offset + n].view(shape)
    return placed(u), placed(gy), torch.from_numpy(k).to(cuda).to(dtype)


def _assert_matches_plain(du, dk, u, gy, k):
    """As test_kernel_matches_plain_and_k4_on_card: float32 du atol 1e-4,
    dk within 1e-5 of the |u gy| sums; bfloat16 du 2e-2 of the largest
    |du|, dk 1e-4 of the sums."""
    kdims = tuple(k.shape[:3])
    pads = depthwise._resolve_pads(u.shape, kdims, (1, 1, 1), "SAME")
    rdu, rdk = depthwise.depthwise_conv3d_pbwd_reference(
        u.float(), gy.float(), k.float())
    scale = depthwise.depthwise_conv3d_dk_reference(
        u.float().abs(), gy.float().abs(), kdims, (1, 1, 1), pads)
    tol_du, tol_dk = (1e-4, 1e-5) if u.dtype == torch.float32 else \
        (2e-2 * rdu.abs().max().item(), 1e-4)
    assert du.dtype == u.dtype and du.shape == u.shape
    assert (du.float() - rdu).abs().max().item() <= tol_du
    assert ((dk.reshape(rdk.shape) - rdk).abs() <= tol_dk * scale
            + 1e-6).all()
    return scale


def _both_bodies(u, gy, k):
    kdims = tuple(k.shape[:3])
    C = u.shape[-1]
    taps = k.float().reshape(-1, C).contiguous()
    lib = depthwise._build.load("depthwise_pbwd.cu",
                                depthwise._PBWD_SIGNATURES)
    stream = depthwise.kernels.stream_handle(u)
    return [depthwise._launch_pbwd(lib, body, u, gy, taps, kdims, stream)
            for body in ("temporal", "generic")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kt", [1, 3, 5])
@pytest.mark.parametrize("plane", [(1, 1), (7, 5)], ids=str)
@pytest.mark.parametrize("C", [1, 3, 24, 33, 40])
@pytest.mark.parametrize("extra", [0, 1], ids=["T_kt", "T_kt1"])
def test_temporal_body_edges_on_card(cuda, dtype, kt, plane, C, extra):
    """T = kt and kt + 1 frames, C of every cell width (1, 3, 33: one
    element; 24, 40: 8 bytes, 4 channels in bfloat16, 2 in float32), a 1x1
    and a 7x5 plane, kt 1, 3 and 5: the temporal body against the plain
    version and against the generic body on the same inputs (du within one
    rounding, dk within 1e-6 of the |u gy| sums)."""
    shape = (2, kt + extra, *plane, C)
    u, gy, k = _on_card(cuda, dtype, shape, (kt, 1, 1), 11)
    assert depthwise.pbwd_body((kt, 1, 1), ((kt // 2,) * 2, (0, 0),
                                            (0, 0))) == "temporal"
    (du, dk), (gdu, gdk) = _both_bodies(u, gy, k)
    torch.cuda.synchronize()
    scale = _assert_matches_plain(du, dk, u, gy, k)
    ulp = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert ((du.float() - gdu.float()).abs()
            <= ulp * gdu.float().abs().clamp_min(1.0)).all()
    assert ((dk - gdk).abs() <= 1e-6 * scale.reshape(dk.shape)
            + 1e-6).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,offset_bytes", [
    (torch.bfloat16, 2), (torch.bfloat16, 4), (torch.bfloat16, 8),
    (torch.bfloat16, 12), (torch.bfloat16, 16), (torch.float32, 4),
    (torch.float32, 8), (torch.float32, 12), (torch.float32, 16)], ids=str)
def test_temporal_body_narrows_the_cell_on_card(cuda, dtype, offset_bytes):
    """u and gy 2 to 16 bytes into their allocations (a float32 tensor
    starts on a 4-byte boundary): the plan narrows the cell to what the
    addresses allow, and the body still matches the plain version."""
    elem = torch.empty((), dtype=dtype).element_size()
    shape = (2, 6, 5, 7, 24)
    u, gy, k = _on_card(cuda, dtype, shape, (5, 1, 1), 12,
                        offset_bytes // elem)
    du, dk = depthwise.depthwise_conv3d_pbwd(u, gy, k)
    torch.cuda.synchronize()
    p = depthwise.pbwd_temporal_plan(*shape, 5, elem, ring.align(u, gy, du))
    assert p["cell_bytes"] == min(depthwise.PBWD_MAX_CELL,
                                  ring.align(u, gy))
    _assert_matches_plain(du, dk, u, gy, k)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["M", "S"])
def test_temporal_body_repeats_bit_for_bit_on_card(cuda, variant):
    """Two runs at a stem's training shape (X3D-M: 32 clips of 16 x 112²,
    X3D-S: 64 of 13 x 80², C = 24, bfloat16) give the same du and dk, bit
    for bit (no atomics; partials summed in a fixed order)."""
    shape, kdims, _ = _stem(variant)
    gen = torch.Generator(device=cuda).manual_seed(0)
    u, gy = (torch.randn(shape, generator=gen, device=cuda)
             .to(torch.bfloat16) for _ in range(2))
    k = (0.3 * torch.randn((*kdims, 1, shape[-1]), generator=gen,
                           device=cuda)).to(torch.bfloat16)
    before = depthwise.depthwise_conv3d_pbwd.body_launches["temporal"]
    first = depthwise.depthwise_conv3d_pbwd(u, gy, k)
    second = depthwise.depthwise_conv3d_pbwd(u, gy, k)
    torch.cuda.synchronize()
    assert depthwise.depthwise_conv3d_pbwd.body_launches["temporal"] == \
        before + 2
    assert all(torch.equal(a, b) for a, b in zip(first, second))
