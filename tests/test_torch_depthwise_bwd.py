"""The depthwise conv's backward (kernel K4: dx and dk) against the JAX
package, and K4 against its plain versions on the card.

On the CPU the wrappers run their plain versions.  They are held against
``jax.vjp`` of ``x3d_tpu.ops.depthwise.depthwise_conv3d`` (XLA impl) for
the X3D cases -- stride 1 3×3×3 SAME, the stem's 5×1×1 with pads (2, 2),
and stride 2 at even and odd H and W, where TF-SAME puts the odd pad on the
high side -- and, at stride 1, against the TPU kernels' own backward,
``dw_batchminor.dw_conv_bm`` and ``pallas_dw.dw_conv_rows`` in interpret
mode.  Tolerances (float32, sums in another order): dx atol 1e-5; dk rtol
1e-5 with atol 1e-4 (sums of a few thousand products of order 1).

dx has two bodies on the card: :func:`depthwise.dx_body` sends the stride-2
stage entries to the parity-phase body and every other geometry to the
gather body.  The phase body's tap rule is written out here in numpy and
held against the plain dx, so an index error shows before the card.  dk has
two bodies too: :func:`depthwise.dk_body` sends every 3x3 conv at spatial
stride 1 or 2 (the stage entries) to the ring body, on K1's ring staging,
and every other geometry to the generic body.  The ring body's plan is
pure Python and is checked over a sweep; its order of sums (thread rows,
blocks, the second pass's chunks) is written out in numpy and held against
the plain dk (float32, rtol 1e-5, atol 1e-4).

JAX is imported inside the tests, so that the card tests (marker ``cuda``)
run on a machine without it:
``python -m pytest --noconftest -m cuda tests/test_torch_depthwise_bwd.py``.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from test_torch_dw_fused import multigrid_phases, x3d_planes
from x3d_tpu_torch import variant_config
from x3d_tpu_torch.ops import depthwise, ring

# (shape, kernel dims, strides, padding)
CASES = [
    ((2, 5, 6, 7, 3), (3, 3, 3), (1, 1, 1), "SAME"),
    ((2, 6, 5, 4, 3), (5, 1, 1), (1, 1, 1), ((2, 2), (0, 0), (0, 0))),
    ((2, 4, 8, 6, 3), (3, 3, 3), (1, 2, 2), "SAME"),      # even H, W
    ((2, 4, 7, 9, 3), (3, 3, 3), (1, 2, 2), "SAME"),      # odd H, W
]
IDS = ["stride1", "stem5x1x1", "stride2_even", "stride2_odd"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, shape, kdims, strides, padding):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    k = (0.3 * rng.normal(size=kdims + (1, shape[-1]))).astype(np.float32)
    pads = depthwise._resolve_pads(shape, kdims, strides, padding)
    out = [depthwise._out_size(n, kd, s, p) for n, kd, s, p in
           zip(shape[1:4], kdims, strides, pads)]
    g = rng.normal(size=(shape[0], *out, shape[-1])).astype(np.float32)
    return x, k, g, pads


def _port(x, k, g, strides, pads):
    xt, kt, gt = (torch.from_numpy(a) for a in (x, k, g))
    dx = depthwise.depthwise_conv3d_dx(gt, kt, xt.shape, strides, pads)
    dk = depthwise.depthwise_conv3d_dk(xt, gt, k.shape[:3], strides, pads)
    return dx.numpy(), dk.numpy()


def _assert_matches(got, want):
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("shape,kdims,strides,padding", CASES, ids=IDS)
def test_matches_jax_vjp(shape, kdims, strides, padding):
    import jax
    from x3d_tpu.ops.depthwise import depthwise_conv3d as jax_dw

    x, k, g, pads = _inputs(0, shape, kdims, strides, padding)
    _, vjp = jax.vjp(lambda x_, k_: jax_dw(x_, k_, strides, pads, impl="xla"),
                     x, k)
    _assert_matches(_port(x, k, g, strides, pads), vjp(g))


def test_stride2_high_side_pad():
    """At stride 2 and even H, W the SAME pad is (0, 1): output row ho's
    centre tap reads input row 2·ho + 1, so with the centre tap alone dx is
    1 on the odd rows and columns; a symmetric (1, 1) pad would put it on
    the even ones."""
    shape, kdims, strides = (1, 3, 4, 4, 1), (1, 3, 3), (1, 2, 2)
    pads = depthwise._resolve_pads(shape, kdims, strides, "SAME")
    assert pads == ((0, 0), (0, 1), (0, 1))
    k = np.zeros(kdims + (1, 1), np.float32)
    k[0, 1, 1, 0, 0] = 1.0                 # the centre tap only
    g = np.ones((1, 3, 2, 2, 1), np.float32)
    dx, _ = _port(np.zeros(shape, np.float32), k, g, strides, pads)
    want = np.zeros(shape, np.float32)
    want[:, :, 1::2, 1::2] = 1.0
    np.testing.assert_array_equal(dx, want)


# X3D's stride-2 stage entries, (T, H, W, C) of x at one clip: X3D-M (16
# frames of 112², 56², 28², 14²) and X3D-S (13 frames of 80², 40², 20², 10²),
# and a 39² plane (X3D-L's stage-4 entry), whose TF-SAME pads are (1, 1)
STAGE_ENTRIES = [(16, 112, 112, 54), (16, 56, 56, 108), (16, 28, 28, 216),
                 (16, 14, 14, 432), (13, 80, 80, 54), (13, 40, 40, 108),
                 (13, 20, 20, 216), (13, 10, 10, 432), (16, 39, 39, 216)]
STAGE_IDS = ["M2", "M3", "M4", "M5", "S2", "S3", "S4", "S5", "odd39"]
# X3D-XS, -L and -XL's stage entries at their training batches: XS at 4
# frames (80² .. 10²), L and XL at 156², 78², 39², 20² (XL 72, 162, 306,
# 630 channels)
NEW_ENTRIES = [(f"{v}{st}", entry, variant_config(v).TRAIN.BATCH_SIZE)
               for v in ("XS", "L", "XL")
               for st, entry, _ in x3d_planes(v, True)]
# every variant's stage entries at its long-cycle multigrid phases (default
# factors; batches 2 to 8 times the config's, X3D-XS down to 1 frame) that
# the lists above do not hold
MULTIGRID_ENTRIES = list({
    (entry, c.TRAIN.BATCH_SIZE): f"{v}{st}-mg{i}-B{c.TRAIN.BATCH_SIZE}"
    for v in ("XS", "S", "M", "L", "XL") for i, c in multigrid_phases(v)
    for st, entry, _ in x3d_planes(v, True, c)
    if entry not in STAGE_ENTRIES + [e for _, e, _ in NEW_ENTRIES]}.items())


@pytest.mark.parametrize(
    "thwc", STAGE_ENTRIES + [e for _, e, _ in NEW_ENTRIES]
    + [e for (e, _), _ in MULTIGRID_ENTRIES],
    ids=STAGE_IDS + [i for i, _, _ in NEW_ENTRIES]
    + [i for _, i in MULTIGRID_ENTRIES])
def test_dx_body_takes_phase_at_stage_entries(thwc):
    kdims, strides = (3, 3, 3), (1, 2, 2)
    pads = depthwise._resolve_pads((1, *thwc), kdims, strides, "SAME")
    assert pads[1] == pads[2] == ((1, 1) if thwc[1] % 2 else (0, 1))
    assert depthwise.dx_body(kdims, strides, pads) == "phase"


@pytest.mark.parametrize("kdims,strides,pads", [
    ((3, 3, 3), (1, 1, 1), ((1, 1), (1, 1), (1, 1))),      # stride 1
    ((5, 1, 1), (1, 1, 1), ((2, 2), (0, 0), (0, 0))),      # the stem's conv_t
    ((3, 1, 1), (1, 2, 2), ((1, 1), (0, 0), (0, 0))),      # taps 1x1
    ((3, 5, 5), (1, 2, 2), ((1, 1), (1, 2), (1, 2))),      # taps 5x5
    ((3, 3, 3), (2, 2, 2), ((0, 1), (0, 1), (0, 1))),      # temporal stride 2
    ((3, 3, 3), (1, 2, 1), ((1, 1), (0, 1), (1, 1))),      # stride 1 along W
    ((3, 3, 3), (1, 2, 2), ((1, 1), (2, 0), (0, 1))),      # low pad 2
    ((6, 3, 3), (1, 2, 2), ((2, 3), (0, 1), (0, 1))),      # kt above 5
], ids=["stride1", "stem5x1x1", "taps1x1", "taps5x5", "tstride2", "wstride1",
        "lowpad2", "kt6"])
def test_dx_body_takes_gather_elsewhere(kdims, strides, pads):
    assert depthwise.dx_body(kdims, strides, pads) == "gather"


def _dx_by_phases(g, k, x_shape, pads):
    """dx of a stride-(1, 2, 2) conv with 3x3 spatial taps, built from its
    four parity phases with the tap rule the phase body hard-codes: in
    virtual rows v = hi + hlo an even v takes dh = 0 from g row v/2 and
    dh = 2 from row v/2 - 1, an odd v takes dh = 1 from row (v - 1)/2;
    columns likewise; frame ti takes dt from g frame ti + tlo - dt."""
    B, T, H, W, C = x_shape
    _, To, Ho, Wo, _ = g.shape
    tlo, hlo, wlo = (p[0] for p in pads)
    nqh, nqw = (H + hlo + 1) // 2, (W + wlo + 1) // 2      # quads
    # gp[:, :, I + 1, J + 1] = g[:, :, I, J], zero outside g
    gp = np.zeros((B, To, nqh + 1, nqw + 1, C), np.float64)
    nh, nw = min(Ho, nqh), min(Wo, nqw)
    gp[:, :, 1:nh + 1, 1:nw + 1] = g[:, :, :nh, :nw]
    rows = {"a": slice(0, nqh), "b": slice(1, nqh + 1)}    # g rows I-1, I
    cols = {"l": slice(0, nqw), "r": slice(1, nqw + 1)}    # g columns J-1, J
    by_parity = {0: [(0, "b", "r"), (2, "a", "l")], 1: [(1, "b", "r")]}
    dxv = np.zeros((B, T, 2 * nqh, 2 * nqw, C), np.float64)
    for ti in range(T):
        for dt in range(k.shape[0]):
            to = ti + tlo - dt
            if not 0 <= to < To:
                continue
            for py, px in np.ndindex(2, 2):
                for dh, row, _ in by_parity[py]:
                    for dw, _, col in by_parity[px]:
                        dxv[:, ti, py::2, px::2] += (
                            k[dt, dh, dw, 0] * gp[:, to, rows[row], cols[col]])
    return dxv[:, :, hlo:hlo + H, wlo:wlo + W]


@pytest.mark.parametrize("shape", [CASES[2][0], CASES[3][0], (2, 5, 39, 39, 4)],
                         ids=["stride2_even", "stride2_odd", "odd39"])
def test_parity_phases_match_plain_dx(shape):
    kdims, strides = (3, 3, 3), (1, 2, 2)
    x, k, g, pads = _inputs(5, shape, kdims, strides, "SAME")
    want = depthwise.depthwise_conv3d_dx_reference(
        torch.from_numpy(g), torch.from_numpy(k), shape, strides, pads)
    np.testing.assert_allclose(_dx_by_phases(g, k, shape, pads),
                               want.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape,kdims", [((2, 3, 4, 5, 6), (3, 3, 3)),
                                         ((1, 4, 5, 3, 11), (3, 1, 1))])
def test_matches_tpu_kernels_interpret(shape, kdims):
    """Stride 1: the JAX package's batch-minor and dense-row kernels' own
    backward (``_dw_bm_bwd``, ``_dw_rows_bwd``), run in interpret mode."""
    import jax
    from x3d_tpu.ops import dw_batchminor, pallas_dw

    x, k, g, pads = _inputs(1, shape, kdims, (1, 1, 1), "SAME")
    got = _port(x, k, g, (1, 1, 1), pads)
    B, T, H, W, C = shape
    old = dw_batchminor.INTERPRET, pallas_dw.INTERPRET
    dw_batchminor.INTERPRET = pallas_dw.INTERPRET = True
    try:
        _, vjp = jax.vjp(lambda x_, k_: dw_batchminor.dw_conv_bm(
            x_, k_, kdims), x, k)
        _assert_matches(got, vjp(g))
        _, vjp = jax.vjp(lambda x_, k_: pallas_dw.dw_conv_rows(
            x_, k_, C, kdims), x.reshape(B, T, H, W * C), k)
        dx, dk = vjp(g.reshape(B, T, H, W * C))
        _assert_matches(got, (np.asarray(dx).reshape(shape), dk))
    finally:
        dw_batchminor.INTERPRET, pallas_dw.INTERPRET = old


@pytest.mark.parametrize("shape,kdims,strides,padding", CASES, ids=IDS)
def test_autograd_op_uses_the_backward(shape, kdims, strides, padding):
    """``depthwise`` (the model's op) differentiates x and the float32 taps
    through dx and dk, and equals autograd of the plain forward."""
    x, k, g, pads = _inputs(2, shape, kdims, strides, padding)
    xt = torch.from_numpy(x).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    y = depthwise.depthwise(xt, kt, strides, padding)
    gx, gk = torch.autograd.grad(y, (xt, kt), torch.from_numpy(g))
    want = _port(x, k, g, strides, pads)
    np.testing.assert_array_equal(gx.numpy(), want[0])
    np.testing.assert_array_equal(gk.numpy(), want[1])
    xr = torch.from_numpy(x).requires_grad_()
    kr = torch.from_numpy(k).requires_grad_()
    yr = depthwise.depthwise_conv3d_reference(xr, kr, strides, pads)
    rx, rk = torch.autograd.grad(yr, (xr, kr), torch.from_numpy(g))
    _assert_matches((gx.numpy(), gk.numpy()), (rx.numpy(), rk.numpy()))


def test_gradient_shape_is_checked():
    x, k, g, pads = _inputs(3, (2, 4, 6, 6, 3), (3, 3, 3), (1, 1, 1), "SAME")
    with pytest.raises(ValueError, match="does not match"):
        depthwise.depthwise_conv3d_dx(torch.from_numpy(g[:, :, :-1]),
                                      torch.from_numpy(k), x.shape,
                                      (1, 1, 1), pads)


def test_non_cpu_tensor_never_falls_back():
    x, k, g, pads = (a if isinstance(a, tuple) else torch.from_numpy(a)
                     .to("meta") for a in
                     _inputs(3, (2, 4, 6, 6, 3), (3, 3, 3), (1, 1, 1),
                             "SAME"))
    with pytest.raises(ValueError, match="CUDA"):
        depthwise.depthwise_conv3d_dx(g, k, x.shape, (1, 1, 1), pads)
    with pytest.raises(ValueError, match="CUDA"):
        depthwise.depthwise_conv3d_dk(x, g, (3, 3, 3), (1, 1, 1), pads)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kdims,strides,padding", CASES + [
    ((3, 16, 28, 28, 54), (3, 3, 3), (1, 2, 2), "SAME"),
    ((2, 16, 14, 14, 70), (5, 1, 1), (1, 1, 1), ((2, 2), (0, 0), (0, 0))),
    ((2, 16, 7, 7, 432), (3, 3, 3), (1, 1, 1), "SAME")] + [
    ((2, *thwc), (3, 3, 3), (1, 2, 2), "SAME") for thwc in STAGE_ENTRIES])
def test_kernel_matches_plain_on_card(cuda, dtype, shape, kdims, strides,
                                      padding):
    """float32: dx atol 1e-4, dk within 1e-5 of the sum of |x·g| for each
    (tap, channel); bfloat16 against the plain version in float32 on the
    same bfloat16 inputs: dx 2e-2 of the largest |dx|, dk 1e-4 of the
    |x·g| sums (dk sums in float32 either way).  dx runs the phase body at
    stride (1, 2, 2) with 3x3 spatial taps, the gather body elsewhere; dk
    the ring body at 3x3 spatial taps and strides (1, s, s), the generic
    body elsewhere; each call counts one launch under its body."""
    x, k, g, pads = (a if isinstance(a, tuple) else
                     torch.from_numpy(a).to(cuda).to(dtype)
                     for a in _inputs(4, shape, kdims, strides, padding))
    body = "phase" if (strides, kdims[1:]) == ((1, 2, 2), (3, 3)) \
        else "gather"
    assert depthwise.dx_body(kdims, strides, pads) == body
    dk_body = "ring" if kdims[1:] == (3, 3) and strides[0] == 1 \
        and strides[1] == strides[2] else "generic"
    assert depthwise.dk_body(kdims, strides, pads) == dk_body
    before = (depthwise.depthwise_conv3d_dx.launches,
              depthwise.depthwise_conv3d_dk.launches,
              dict(depthwise.depthwise_conv3d_dx.body_launches),
              dict(depthwise.depthwise_conv3d_dk.body_launches))
    dx = depthwise.depthwise_conv3d_dx(g, k, x.shape, strides, pads)
    dk = depthwise.depthwise_conv3d_dk(x, g, kdims, strides, pads)
    torch.cuda.synchronize()
    assert (depthwise.depthwise_conv3d_dx.launches,
            depthwise.depthwise_conv3d_dk.launches) == (before[0] + 1,
                                                        before[1] + 1)
    assert depthwise.depthwise_conv3d_dx.body_launches == \
        before[2] | {body: before[2][body] + 1}
    assert depthwise.depthwise_conv3d_dk.body_launches == \
        before[3] | {dk_body: before[3][dk_body] + 1}
    rdx = depthwise.depthwise_conv3d_dx_reference(g.float(), k.float(),
                                                  x.shape, strides, pads)
    rdk = depthwise.depthwise_conv3d_dk_reference(x.float(), g.float(),
                                                  kdims, strides, pads)
    scale = depthwise.depthwise_conv3d_dk_reference(
        x.float().abs(), g.float().abs(), kdims, strides, pads)
    tol_dx, tol_dk = (1e-4, 1e-5) if dtype == torch.float32 else \
        (2e-2 * rdx.abs().max().item(), 1e-4)
    assert dx.dtype == dtype and dk.dtype == torch.float32
    assert (dx.float() - rdx).abs().max().item() <= tol_dx
    assert ((dk - rdk).abs() <= tol_dk * scale + 1e-6).all()


def _on_card_at(a, cuda, dtype, offset_bytes):
    """``a`` as a CUDA tensor of ``dtype`` that starts ``offset_bytes`` into
    its allocation."""
    n = offset_bytes * 8 // torch.finfo(dtype).bits
    buf = torch.empty(n + a.size, dtype=dtype, device=cuda)
    t = buf[n:].view(a.shape)
    t.copy_(torch.from_numpy(a))
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,offset", [
    (torch.bfloat16, 2), (torch.bfloat16, 4), (torch.bfloat16, 8),
    (torch.bfloat16, 16), (torch.float32, 4), (torch.float32, 8),
    (torch.float32, 16)])
@pytest.mark.parametrize("shape", [(2, 5, 28, 28, 54), (2, 5, 14, 14, 108),
                                   (2, 5, 14, 14, 216)],
                         ids=["C54", "C108", "C216"])
def test_phase_body_takes_unaligned_g(cuda, dtype, offset, shape):
    """g starting 2 to 16 bytes into its allocation: the copy granule
    shrinks to what the address allows; dx as in the test above."""
    kdims, strides = (3, 3, 3), (1, 2, 2)
    _, k, g, pads = _inputs(6, shape, kdims, strides, "SAME")
    gt = _on_card_at(g, cuda, dtype, offset)
    assert gt.data_ptr() % 32 == offset % 32
    kt = torch.from_numpy(k).to(cuda).to(dtype)
    dx = depthwise.depthwise_conv3d_dx(gt, kt, shape, strides, pads)
    rdx = depthwise.depthwise_conv3d_dx_reference(gt.float(), kt.float(),
                                                  shape, strides, pads)
    tol = 1e-4 if dtype == torch.float32 else 2e-2 * rdx.abs().max().item()
    assert (dx.float() - rdx).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("thwc", STAGE_ENTRIES[:4], ids=STAGE_IDS[:4])
def test_phase_body_repeats_bit_for_bit(cuda, thwc):
    """No atomics: each dx element is written once, so bfloat16 calls on
    one input give equal bits."""
    kdims, strides = (3, 3, 3), (1, 2, 2)
    _, k, g, pads = (a if isinstance(a, tuple) else
                     torch.from_numpy(a).to(cuda).to(torch.bfloat16)
                     for a in _inputs(7, (2, *thwc), kdims, strides, "SAME"))
    first = depthwise.depthwise_conv3d_dx(g, k, (2, *thwc), strides, pads)
    second = depthwise.depthwise_conv3d_dx(g, k, (2, *thwc), strides, pads)
    assert torch.equal(first, second)


# ------------------------------------------------------------ dk's bodies

@pytest.mark.parametrize(
    "thwc", STAGE_ENTRIES + [e for _, e, _ in NEW_ENTRIES]
    + [e for (e, _), _ in MULTIGRID_ENTRIES],
    ids=STAGE_IDS + [i for i, _, _ in NEW_ENTRIES]
    + [i for _, i in MULTIGRID_ENTRIES])
def test_dk_body_takes_ring_at_stage_entries(thwc):
    kdims, strides = (3, 3, 3), (1, 2, 2)
    pads = depthwise._resolve_pads((1, *thwc), kdims, strides, "SAME")
    assert depthwise.dk_body(kdims, strides, pads) == "ring"


@pytest.mark.parametrize("kdims,strides,pads", [
    ((5, 1, 1), (1, 1, 1), ((2, 2), (0, 0), (0, 0))),      # X3D-XS's stem
    ((6, 3, 3), (1, 2, 2), ((2, 3), (0, 1), (0, 1))),      # kt above 5
    ((3, 3, 3), (1, 3, 3), ((1, 1), (1, 1), (1, 1))),      # stride 3
    ((3, 3, 3), (1, 2, 2), ((1, 1), (2, 0), (0, 1))),      # low pad 2
    ((3, 3, 3), (1, 2, 2), ((3, 0), (1, 1), (1, 1))),      # low t pad kt
    ((3, 5, 5), (1, 2, 2), ((1, 1), (1, 2), (1, 2))),      # taps 5x5
    ((3, 3, 3), (2, 2, 2), ((0, 1), (0, 1), (0, 1))),      # temporal stride 2
    ((3, 3, 3), (1, 2, 1), ((1, 1), (0, 1), (1, 1))),      # stride 1 along W
], ids=["xs_stem", "kt6", "stride3", "lowpad2", "tpad3", "taps5x5",
        "tstride2", "wstride1"])
def test_dk_body_takes_generic_elsewhere(kdims, strides, pads):
    assert depthwise.dk_body(kdims, strides, pads) == "generic"


def _check_dk_plan(B, To, Ho, Wo, C, kt, stride, elem, align):
    p = depthwise.dk_ring_plan(B, To, Ho, Wo, C, kt, stride, elem, align)
    most = ring.RING_MAX_SIDE if stride == 1 else ring.RING_MAX_SIDE_2
    for n, side, tiles in ((Ho, p["tile_h"], p["tiles_h"]),
                           (Wo, p["tile_w"], p["tiles_w"])):
        assert 1 <= side <= most and (tiles - 1) * side < n <= tiles * side
    vec = p["vec"]
    assert vec == (2 if C % 2 == 0 else 1) and p["group"] % vec == 0
    cell = vec * elem
    assert p["granule"] == (cell if cell >= 4 and align % cell == 0
                            else elem)
    assert (p["groups"] - 1) * p["group"] < C <= p["groups"] * p["group"]
    assert p["rows"] == p["tile_h"]                    # a tile row a thread
    block = p["group"] // vec * p["rows"]
    assert block <= ring.RING_MAX_THREADS
    assert p["threads"] == -(-block // 32) * 32
    slot = ring.ring_slot(p["group"] // vec, vec, elem, p["tile_h"],
                          p["row_cells"], p["vec_pad"], stride)
    assert p["smem_bytes"] <= depthwise.CONV_RING_SMEM
    assert p["smem_bytes"] >= (kt + ring.RING_AHEAD) * slot
    assert p["smem_bytes"] >= p["rows"] * 9 * kt * p["group"] * 4
    assert p["row_cells"] >= ring.ring_cols(p["tile_w"], stride)
    assert (p["runs"], p["run"]) == (1, To)       # a block walks all frames
    tiles = p["tiles_h"] * p["tiles_w"]
    assert p["parts"] == B * tiles * p["runs"]
    assert p["partials"] == B * tiles * p["runs"] * p["groups"]
    return p


@settings(max_examples=300, deadline=None, database=None)
@given(B=st.integers(1, 64), To=st.integers(1, 20), Ho=st.integers(1, 60),
       Wo=st.integers(1, 60), C=st.integers(1, 500), kt=st.integers(1, 5),
       stride=st.sampled_from([1, 2]), layout=st.sampled_from(
           [(2, 16), (2, 2), (4, 16), (4, 4), (2, 8)]))
def test_dk_ring_plan_invariants(B, To, Ho, Wo, C, kt, stride, layout):
    """Over a sweep of shapes, element sizes and alignments: tiles of at
    most the ring side cover Ho x Wo, channel groups cover C, the copy
    granule is a cell where the address allows, one tile row a thread and
    at most RING_MAX_THREADS threads, shared memory within CONV_RING_SMEM
    and enough for the ring and for the rows' sums, one run of all the
    frames, and the partials are clips x tiles x runs x groups blocks in
    clips x tiles x runs rows."""
    _check_dk_plan(B, To, Ho, Wo, C, kt, stride, *layout)


@pytest.mark.parametrize("elem,align", [(2, 16), (2, 2), (4, 16)])
@pytest.mark.parametrize("thwc,B", [(e, 32 if e[0] == 16 else 64)
                                    for e in STAGE_ENTRIES]
                         + [(e, B) for _, e, B in NEW_ENTRIES]
                         + [eb for eb, _ in MULTIGRID_ENTRIES],
                         ids=STAGE_IDS + [i for i, _, _ in NEW_ENTRIES]
                         + [i for _, i in MULTIGRID_ENTRIES])
def test_dk_ring_plan_at_stage_entries(thwc, B, elem, align):
    """The plan of every X3D-M (32 clips), X3D-S (64 clips), X3D-XS (128),
    X3D-L and X3D-XL (16) stage entry, and of every variant's entries at
    its multigrid phases (up to 1024 clips of 1 frame at X3D-XS),
    keeps the invariants above, in bfloat16 and float32, at aligned and
    unaligned addresses."""
    kdims, strides = (3, 3, 3), (1, 2, 2)
    shape = (B, *thwc)
    pads = depthwise._resolve_pads(shape, kdims, strides, "SAME")
    out = [depthwise._out_size(n, k, s_, p_) for n, k, s_, p_ in
           zip(thwc[:3], kdims, strides, pads)]
    p = _check_dk_plan(B, *out, thwc[3], 3, 2, elem, align)
    assert p["vec"] == 2


def _dk_by_ring_partials(x, g, kdims, strides, pads):
    """dk rebuilt in numpy in the ring body's order of sums: for each block
    of the plan (clip, tile, run; channel groups only split C) each thread
    row sums in float32 over its run's frames and its row's pixels (runs of
    four, then pairs) the staged x cell times the pixel's g, cell j of a run
    feeding pixel k's tap dw = j - s k; the rows are added in order into one
    partial per (clip, tile, run), and the second pass adds the partials in
    kSumLanes (16) interleaved chunks in double, then the chunks in order."""
    B, T, H, W, C = x.shape
    _, To, Ho, Wo, _ = g.shape
    kt, s = kdims[0], strides[1]
    (tlo, _), (hlo, _), (wlo, _) = pads
    p = depthwise.dk_ring_plan(B, To, Ho, Wo, C, kt, s, 4, 16)
    TH, TW, WP = p["tile_h"], p["tile_w"], p["row_cells"]
    part = np.zeros((p["parts"], kt, 9, C), np.float32)
    for b in range(B):
        for th in range(p["tiles_h"]):
            for tw in range(p["tiles_w"]):
                h0, w0 = th * TH, tw * TW
                staged = np.zeros((T, ring.ring_rows(TH, s), WP, C),
                                  np.float32)
                for pr in range(staged.shape[1]):
                    for pc in range(WP):
                        hi, wi = h0 * s - hlo + pr, w0 * s - wlo + pc
                        if 0 <= hi < H and 0 <= wi < W:
                            staged[:, pr, pc] = x[b, :, hi, wi]
                cols = min(TW, Wo - w0)
                for run in range(p["runs"]):
                    rows = np.zeros((TH, kt, 9, C), np.float32)
                    for oh in range(min(TH, Ho - h0)):
                        for t in range(run * p["run"],
                                       min((run + 1) * p["run"], To)):
                            ow = 0
                            while ow < cols:
                                n = 4 if ow + 4 <= cols else 2
                                gv = np.zeros((n, C), np.float32)
                                valid = min(n, cols - ow)
                                gv[:valid] = g[b, t, h0 + oh,
                                               w0 + ow:w0 + ow + valid]
                                for dt in range(kt):
                                    tp = t - tlo + dt
                                    if not 0 <= tp < T:
                                        continue
                                    for dh in range(3):
                                        row = staged[tp, s * oh + dh, s * ow:]
                                        for j in range(s * (n - 1) + 3):
                                            for k in range(n):
                                                dw = j - s * k
                                                if 0 <= dw < 3:
                                                    rows[oh, dt, 3 * dh + dw] \
                                                        += row[j] * gv[k]
                                ow += n
                    acc = np.zeros((kt, 9, C), np.float32)
                    for r in range(TH):
                        acc += rows[r]
                    part[((b * p["tiles_h"] + th) * p["tiles_w"] + tw)
                         * p["runs"] + run] = acc
    lanes = [part[lane::16].astype(np.float64).sum(axis=0)
             if lane < len(part) else 0.0 for lane in range(16)]
    total = np.zeros((kt, 9, C), np.float64)
    for lane in lanes:
        total += lane
    return total.astype(np.float32).reshape(kt, 3, 3, 1, C)


@pytest.mark.parametrize("shape,kdims,strides,padding", [
    ((2, 4, 9, 11, 3), (3, 3, 3), (1, 2, 2), "SAME"),      # odd: (1, 1)
    ((2, 9, 8, 10, 4), (3, 3, 3), (1, 2, 2), "SAME"),      # even: (0, 1)
    ((1, 3, 20, 17, 2), (5, 3, 3), (1, 2, 2), "SAME"),     # 2x2 tiles
    ((1, 3, 7, 9, 2), (1, 3, 3), (1, 2, 2), ((0, 0), (0, 2), (1, 0))),
    ((2, 4, 9, 11, 3), (3, 3, 3), (1, 1, 1), "SAME"),
    ((1, 9, 16, 17, 5), (2, 3, 3), (1, 1, 1), ((0, 1), (0, 2), (1, 1))),
], ids=["stride2_odd", "stride2_even", "tiles", "kt1_pads", "stride1",
        "stride1_tiles"])
def test_dk_ring_partials_rebuild_dk(shape, kdims, strides, padding):
    x, k, g, pads = _inputs(8, shape, kdims, strides, padding)
    assert depthwise.dk_body(kdims, strides, pads) == "ring"
    want = depthwise.depthwise_conv3d_dk_reference(
        torch.from_numpy(x), torch.from_numpy(g), kdims, strides, pads)
    got = _dk_by_ring_partials(x, g, kdims, strides, pads)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-4)


class _FailingDkLibrary:
    """A K4 library whose dk ring body fails at launch; it records the
    calls."""

    def __init__(self):
        self.calls = []

    def x3d_dw_conv3d_dk_ring(self, *args):
        self.calls.append("ring")
        return 1                                   # cudaErrorInvalidValue

    def __getattr__(self, name):                   # the generic body's
        raise AssertionError(f"fell back to {name}")


def test_failed_dk_ring_launch_raises_without_fallback():
    """A dk ring-body launch that returns an error raises; the generic body
    is never asked to take over."""
    shape, kdims, strides = (2, 5, 6, 6, 8), (3, 3, 3), (1, 2, 2)
    x, _, g, pads = _inputs(9, shape, kdims, strides, "SAME")
    lib = _FailingDkLibrary()
    with pytest.raises(RuntimeError, match=r"ring body.*CUDA error 1"):
        depthwise._launch_dk(lib, "ring", torch.from_numpy(x),
                             torch.from_numpy(g), kdims, strides, pads, 0)
    assert lib.calls == ["ring"]


# ------------------------------------------------- dk's ring body, on card

def _assert_dk_matches_plain(dk, x, g, kdims, strides, pads):
    """float32 dk within 1e-5 of each (tap, channel)'s sum of |x·g|,
    bfloat16 within 1e-4 (the plain version in float32 on the same
    inputs); as in test_kernel_matches_plain_on_card."""
    rdk = depthwise.depthwise_conv3d_dk_reference(x.float(), g.float(),
                                                  kdims, strides, pads)
    scale = depthwise.depthwise_conv3d_dk_reference(
        x.float().abs(), g.float().abs(), kdims, strides, pads)
    tol = 1e-5 if x.dtype == torch.float32 else 1e-4
    assert dk.dtype == torch.float32
    assert ((dk - rdk).abs() <= tol * scale + 1e-6).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kdims,strides", [
    ((2, 16, 14, 14, 432), (3, 3, 3), (1, 2, 2)),     # X3D-M stage 5: 7²
    ((2, 13, 10, 10, 432), (3, 3, 3), (1, 2, 2)),     # X3D-S stage 5: 5²
    ((2, 6, 13, 15, 7), (3, 3, 3), (1, 2, 2)),        # odd C: VE 1
    ((2, 6, 28, 28, 54), (1, 3, 3), (1, 2, 2)),
    ((2, 6, 28, 28, 54), (2, 3, 3), (1, 2, 2)),
    ((2, 6, 28, 28, 54), (4, 3, 3), (1, 2, 2)),
    ((2, 6, 28, 28, 54), (5, 3, 3), (1, 2, 2)),
    ((2, 7, 21, 19, 33), (3, 3, 3), (1, 1, 1)),       # stride 1, odd C
    ((3, 5, 39, 39, 70), (5, 3, 3), (1, 2, 2)),
], ids=["M5_7sq", "S5_5sq", "oddC", "kt1", "kt2", "kt4", "kt5", "stride1",
        "odd39_kt5"])
def test_dk_ring_edges_on_card(cuda, dtype, shape, kdims, strides):
    """Ragged planes (7² and 5² outputs), odd C (a vector of one channel),
    kt 1 to 5 and stride 1: the ring body against the plain version."""
    x, _, g, pads = (a if isinstance(a, tuple) else
                     torch.from_numpy(a).to(cuda).to(dtype)
                     for a in _inputs(10, shape, kdims, strides, "SAME"))
    assert depthwise.dk_body(kdims, strides, pads) == "ring"
    dk = depthwise.depthwise_conv3d_dk(x, g, kdims, strides, pads)
    _assert_dk_matches_plain(dk, x, g, kdims, strides, pads)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,offset", [
    (torch.bfloat16, 2), (torch.bfloat16, 4), (torch.bfloat16, 8),
    (torch.bfloat16, 16), (torch.float32, 4), (torch.float32, 8),
    (torch.float32, 16)])
@pytest.mark.parametrize("which", ["x", "g", "both"])
def test_dk_ring_takes_unaligned_inputs(cuda, dtype, offset, which):
    """x, g or both starting 2 to 16 bytes into their allocations: x's copy
    granule shrinks to what its address allows, g is read an element at a
    time where its address does not allow a vector."""
    shape, kdims, strides = (2, 5, 28, 28, 54), (3, 3, 3), (1, 2, 2)
    x, _, g, pads = _inputs(11, shape, kdims, strides, "SAME")
    xt = _on_card_at(x, cuda, dtype, offset if which != "g" else 0)
    gt = _on_card_at(g, cuda, dtype, offset if which != "x" else 0)
    dk = depthwise.depthwise_conv3d_dk(xt, gt, kdims, strides, pads)
    _assert_dk_matches_plain(dk, xt, gt, kdims, strides, pads)


@pytest.mark.cuda
@pytest.mark.parametrize("thwc", STAGE_ENTRIES, ids=STAGE_IDS)
def test_dk_ring_matches_generic_body(cuda, thwc):
    """The ring body and the generic body on the same float32 inputs: the
    same sums in another order, within 1e-5 of the |x·g| sums."""
    kdims, strides = (3, 3, 3), (1, 2, 2)
    x, _, g, pads = (a if isinstance(a, tuple) else
                     torch.from_numpy(a).to(cuda)
                     for a in _inputs(12, (2, *thwc), kdims, strides, "SAME"))
    from x3d_tpu_torch.kernels import _build
    lib = _build.load("depthwise_bwd.cu", depthwise._BWD_SIGNATURES)
    stream = torch.cuda.current_stream().cuda_stream
    got, want = (depthwise._launch_dk(lib, body, x, g, kdims, strides, pads,
                                      stream) for body in ("ring", "generic"))
    scale = depthwise.depthwise_conv3d_dk_reference(
        x.abs(), g.abs(), kdims, strides, pads).reshape(got.shape)
    assert ((got - want).abs() <= 1e-5 * scale + 1e-6).all()


@pytest.mark.cuda
@pytest.mark.parametrize("thwc", STAGE_ENTRIES[:8], ids=STAGE_IDS[:8])
def test_dk_ring_repeats_bit_for_bit(cuda, thwc):
    """No atomics and a fixed order of sums: bfloat16 dk of one input gives
    equal bits twice, at the training batch (X3D-M 32 clips, X3D-S 64)."""
    B = 32 if thwc[0] == 16 else 64
    kdims, strides = (3, 3, 3), (1, 2, 2)
    pads = depthwise._resolve_pads((B, *thwc), kdims, strides, "SAME")
    out = [depthwise._out_size(n, k, s_, p_) for n, k, s_, p_ in
           zip(thwc[:3], kdims, strides, pads)]
    gen = torch.Generator(device=cuda).manual_seed(13)
    x = torch.randn((B, *thwc), generator=gen, device=cuda).bfloat16()
    g = torch.randn((B, *out, thwc[3]), generator=gen, device=cuda).bfloat16()
    first = depthwise.depthwise_conv3d_dk(x, g, kdims, strides, pads)
    second = depthwise.depthwise_conv3d_dk(x, g, kdims, strides, pads)
    assert torch.equal(first, second)
