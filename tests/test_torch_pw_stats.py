"""The pointwise convs with BN sums (kernels K5 and K6) against the JAX
package, and the kernels against their plain versions on the card.

On the CPU the wrappers run their plain versions.  At 8-aligned channels
the forward (y, p, s2) and the vjp (dx, dW; for K6 also da, db) are held
against the JAX package's ``pw_batchminor.pw_conv_bm_stats`` and
``pw_act_conv_bm_stats`` -- Pallas kernels with plain-XLA backward rules --
in interpret mode.  At X3D-M's unaligned widths (54 channels) the TPU
kernels do not apply, and ``jax.vjp`` of the einsum composition with the
same semantics is the reference.  The sums are taken from the float32
product before it is rounded; the test pins that with bfloat16 inputs.

Tolerances (float32, sums in another order): y atol 1e-5; p, s2 rtol 1e-5
with atol 1e-4; gradients rtol 1e-5 with atol 1e-4.

JAX is imported inside the tests, so that the card tests (marker ``cuda``)
run on a machine without it:
``python -m pytest --noconftest -m cuda tests/test_torch_pw_stats.py``.
"""

import numpy as np
import pytest
import torch

from x3d_tpu_torch.ops import pw_stats


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, shape, cout):
    rng = np.random.default_rng(seed)
    B, cin = shape[0], shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    w = (0.3 * rng.normal(size=(cout, cin))).astype(np.float32)
    a = (0.5 + rng.uniform(size=(cin, B))).astype(np.float32)
    b = (0.5 * rng.normal(size=(cin, B))).astype(np.float32)
    out = shape[:-1] + (cout,)
    gy = rng.normal(size=out).astype(np.float32)
    gp = (0.1 * rng.normal(size=(cout, B))).astype(np.float32)
    gs2 = (0.05 * rng.normal(size=(cout, B))).astype(np.float32)
    return x, w, a, b, (gy, gp, gs2)


def _port(act, x, w, a, b, cots):
    """Forward outputs and gradients of the port's differentiable op."""
    xt, wt = torch.from_numpy(x).requires_grad_(), \
        torch.from_numpy(w).requires_grad_()
    if act:
        at, bt = torch.from_numpy(a).requires_grad_(), \
            torch.from_numpy(b).requires_grad_()
        ins = [xt, at, bt, wt]
        outs = pw_stats.act_conv_stats(xt, at, bt, wt)
    else:
        ins = [xt, wt]
        outs = pw_stats.conv_stats(xt, wt)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots))
    grads = torch.autograd.grad(loss, ins)
    return [o.detach().numpy() for o in outs], [g.numpy() for g in grads]


def _jax_fns(act):
    """The JAX package's op (kernel weights (Cin, Cout)) and its einsum
    composition, both taking (x, [a, b,] W (Cout, Cin))."""
    import jax
    import jax.numpy as jnp
    from x3d_tpu.ops import pw_batchminor

    def compose(x, *rest):
        *coefs, w = rest
        u = x
        if act:
            a, b = coefs
            v = x * jnp.transpose(a)[:, None, None, None] \
                + jnp.transpose(b)[:, None, None, None]
            u = (v * jax.nn.sigmoid(v)).astype(x.dtype)
        y32 = jnp.einsum("bthwc,dc->bthwd", u.astype(jnp.float32),
                         w.astype(jnp.float32))
        p = jnp.transpose(jnp.sum(y32, axis=(1, 2, 3)))
        s2 = jnp.transpose(jnp.sum(y32 * y32, axis=(1, 2, 3)))
        return y32.astype(x.dtype), p, s2

    def kernel(x, *rest):
        *coefs, w = rest
        if act:
            return pw_batchminor.pw_act_conv_bm_stats(x, *coefs,
                                                      jnp.transpose(w))
        return pw_batchminor.pw_conv_bm_stats(x, jnp.transpose(w))

    return kernel, compose


def _assert_matches(got, want):
    (outs, grads), (w_outs, w_grads) = got, want
    np.testing.assert_allclose(outs[0], np.asarray(w_outs[0]), rtol=0,
                               atol=1e-5)
    for o, w in zip(outs[1:], w_outs[1:]):
        np.testing.assert_allclose(o, np.asarray(w), rtol=1e-5, atol=1e-4)
    assert len(grads) == len(w_grads)
    for g, w in zip(grads, w_grads):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-4)


def _jax_vjp(fn, args, cots):
    import jax
    outs, vjp = jax.vjp(fn, *args)
    return outs, vjp(cots)


@pytest.mark.parametrize("act", [False, True], ids=["K5", "K6"])
def test_matches_jax_kernels_interpret(act):
    import jax
    from x3d_tpu.ops import pw_batchminor

    x, w, a, b, cots = _inputs(0, (2, 3, 4, 6, 8), 16)
    args = [x, a, b, w] if act else [x, w]
    old = pw_batchminor.INTERPRET
    pw_batchminor.INTERPRET = True
    try:
        kernel, _ = _jax_fns(act)
        want = jax.jit(lambda *t: _jax_vjp(kernel, t, cots))(*args)
    finally:
        pw_batchminor.INTERPRET = old
    _assert_matches(_port(act, x, w, a, b, cots), want)


@pytest.mark.parametrize("cin,cout", [(24, 54), (54, 24), (7, 5)])
@pytest.mark.parametrize("act", [False, True], ids=["K5", "K6"])
def test_matches_jax_composition_unaligned(act, cin, cout):
    x, w, a, b, cots = _inputs(1, (2, 3, 4, 5, cin), cout)
    args = [x, a, b, w] if act else [x, w]
    _, compose = _jax_fns(act)
    _assert_matches(_port(act, x, w, a, b, cots),
                    _jax_vjp(compose, args, cots))


@pytest.mark.parametrize("act", [False, True], ids=["K5", "K6"])
def test_sums_are_taken_before_rounding(act):
    """bfloat16 inputs: p and s2 are the float32 product's sums, not those
    of y as stored in bfloat16."""
    x, w, a, b, _ = _inputs(2, (2, 3, 4, 5, 24), 54)
    xb = torch.from_numpy(x).bfloat16()
    wt = torch.from_numpy(w)
    if act:
        at, bt = torch.from_numpy(a), torch.from_numpy(b)
        y, p, s2 = pw_stats.pw_act_conv_stats(xb, at, bt, wt)
        v = xb.float() * at.t()[:, None, None, None] + bt.t()[:, None, None,
                                                               None]
        u = (v * torch.sigmoid(v)).bfloat16().float()
    else:
        y, p, s2 = pw_stats.pw_conv_stats(xb, wt)
        u = xb.float()
    y32 = u @ wt.bfloat16().float().t()
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y, y32.bfloat16(), rtol=0, atol=0)
    np.testing.assert_allclose(p.numpy(), y32.sum(dim=(1, 2, 3)).t().numpy(),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        s2.numpy(), (y32 * y32).sum(dim=(1, 2, 3)).t().numpy(), rtol=1e-5,
        atol=1e-4)
    stored = y.float()
    assert not np.allclose(p.numpy(), stored.sum(dim=(1, 2, 3)).t().numpy(),
                           rtol=1e-6, atol=0)


def test_shapes_are_checked():
    x, w, a, b, _ = _inputs(3, (2, 3, 4, 5, 8), 16)
    with pytest.raises(ValueError, match="Cout, Cin"):
        pw_stats.pw_conv_stats(torch.from_numpy(x), torch.from_numpy(w.T))
    with pytest.raises(ValueError, match="columns"):
        pw_stats.pw_act_conv_stats(torch.from_numpy(x), torch.from_numpy(a.T),
                                   torch.from_numpy(b), torch.from_numpy(w))


def test_read_plan_reports_by_key():
    """The plan functions' int array comes back by key, and an error code
    raises."""
    import ctypes

    from x3d_tpu_torch import kernels

    def fake(K, N, act, out):
        values = (ctypes.c_int * len(kernels.PLAN_KEYS)).from_address(out)
        values[:] = [16, N, 1, 4096 + K, 2, 3 + act]
        return 0

    assert kernels.read_plan(fake, 24, 56, 1) == dict(
        granule_bytes=16, block_columns=56, column_tiles=1, smem_bytes=4120,
        blocks_per_sm=2, stages=4)
    with pytest.raises(RuntimeError, match="plan"):
        kernels.read_plan(lambda out: 1)


def test_non_cpu_tensor_never_falls_back():
    x, w, a, b, _ = (v if isinstance(v, tuple) else
                     torch.from_numpy(v).to("meta")
                     for v in _inputs(4, (2, 3, 4, 5, 8), 16))
    with pytest.raises(ValueError, match="CUDA"):
        pw_stats.pw_conv_stats(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        pw_stats.pw_act_conv_stats(x, a, b, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [False, True], ids=["K5", "K6"])
@pytest.mark.parametrize("shape,cout", [
    ((2, 3, 4, 5, 8), 16), ((3, 4, 7, 7, 24), 54), ((2, 16, 7, 7, 432), 192),
    ((2, 16, 14, 14, 96), 216), ((1, 1, 3, 1, 5), 70),
    # K = 54 and 108: rows of 108 and 216 bytes (4- and 8-byte granules)
    ((2, 4, 7, 7, 54), 24), ((2, 4, 7, 7, 54), 48), ((2, 4, 7, 7, 108), 24),
    ((2, 4, 7, 7, 108), 48),
    # X3D-S's stage 5: S = 325, odd and no multiple of a row tile
    ((2, 13, 5, 5, 432), 192),
    # X3D-XL's widths, 2 mod 4 (4-byte granules) and N 630 (five column
    # tiles of 16 mma tiles) or K 630 with N 280 (two of 18)
    ((2, 16, 10, 10, 280), 630), ((2, 16, 10, 10, 630), 280),
    ((2, 16, 20, 20, 136), 306), ((2, 16, 20, 20, 306), 136)])
def test_kernel_matches_plain_on_card(cuda, dtype, act, shape, cout):
    """The plain version on the same inputs (float32 matmul, TF32 off)
    rounds u to x's dtype as the kernel does: y within 1e-5 (float32) or
    one bfloat16 rounding (2e-2 of the largest |y|) of it, and p, s2 within
    1e-4 of the same sums over |x| |W| (for K6 over swish(|x| |a| + |b| +
    1), which bounds |swish(x a + b)|)."""
    x, w, a, b, _ = (v if isinstance(v, tuple) else
                     torch.from_numpy(v).to(cuda)
                     for v in _inputs(5, shape, cout))
    x = x.to(dtype)
    fn = pw_stats.pw_act_conv_stats if act else pw_stats.pw_conv_stats
    ref = pw_stats.pw_act_conv_stats_reference if act \
        else pw_stats.pw_conv_stats_reference
    args = (x, a, b, w) if act else (x, w)
    before = fn.launches
    y, p, s2 = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    yr, pr, s2r = ref(*args)
    absargs = (x.float().abs(), a.abs(), b.abs() + 1.0, w.abs()) if act \
        else (x.float().abs(), w.abs())
    _, pa, s2a = ref(*absargs)
    tol_y = 1e-5 * max(1.0, yr.float().abs().max().item()) \
        if dtype == torch.float32 else 2e-2 * yr.float().abs().max().item()
    assert y.dtype == dtype
    assert (y.float() - yr.float()).abs().max().item() <= tol_y
    assert ((p - pr).abs() <= 1e-4 * pa + 1e-5).all()
    assert ((s2 - s2r).abs() <= 1e-4 * s2a + 1e-5).all()


def _check_against_plain(act, args, y, p, s2):
    """y within one bfloat16 rounding (2e-2 of the largest |y|) of the plain
    version's, p and s2 within 1e-4 of the sums over absolute values."""
    ref = pw_stats.pw_act_conv_stats_reference if act \
        else pw_stats.pw_conv_stats_reference
    yr, pr, s2r = ref(*args)
    x, w = args[0], args[-1]
    absargs = (x.float().abs(), args[1].abs(), args[2].abs() + 1.0,
               w.abs()) if act else (x.float().abs(), w.abs())
    _, pa, s2a = ref(*absargs)
    assert (y.float() - yr.float()).abs().max().item() \
        <= 2e-2 * yr.float().abs().max().item()
    assert ((p - pr).abs() <= 1e-4 * pa + 1e-5).all()
    assert ((s2 - s2r).abs() <= 1e-4 * s2a + 1e-5).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cout", [
    ((2, 13, 5, 5, 54), 24), ((3, 4, 7, 7, 108), 48),
    ((2, 13, 5, 5, 432), 192)])
def test_act_masks_padding_on_card(cuda, shape, cout):
    """K6 with offsets b of 4 to 6: swish(b) is far from 0, so a u left
    unmasked on the rows past a sample's last row tile or at k >= K would
    show in y, p and s2 (each shape's S is no multiple of the row tile, and
    54, 108 no multiple of the k-tile)."""
    x, w, a, _, _ = (v if isinstance(v, tuple) else
                     torch.from_numpy(v).to(cuda)
                     for v in _inputs(6, shape, cout))
    b = 4.0 + 2.0 * torch.rand(a.shape, generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda)
    args = (x.bfloat16(), a, b, w)
    y, p, s2 = pw_stats.pw_act_conv_stats(*args)
    torch.cuda.synchronize()
    _check_against_plain(True, args, y, p, s2)


@pytest.mark.cuda
@pytest.mark.parametrize("act", [False, True], ids=["K5", "K6"])
@pytest.mark.parametrize("offset", [1, 2, 4, 8])
def test_unaligned_base_on_card(cuda, act, offset):
    """x starting 2, 4, 8 or 16 bytes into an allocation: the copy granule
    is picked from the base pointers at launch (an odd element offset
    takes the CUDA-core route), and every route agrees with the plain
    version."""
    shape, cout = (2, 4, 7, 7, 432), 48
    x, w, a, b, _ = (v if isinstance(v, tuple) else
                     torch.from_numpy(v).to(cuda)
                     for v in _inputs(7, shape, cout))
    flat = torch.empty(x.numel() + offset, dtype=torch.bfloat16, device=cuda)
    xs = flat[offset:].view(shape)
    xs.copy_(x)
    args = (xs, a, b, w) if act else (xs, w)
    fn = pw_stats.pw_act_conv_stats if act else pw_stats.pw_conv_stats
    y, p, s2 = fn(*args)
    torch.cuda.synchronize()
    _check_against_plain(act, args, y, p, s2)


@pytest.mark.cuda
@pytest.mark.parametrize("act", [False, True], ids=["K5", "K6"])
@pytest.mark.parametrize("shape,cout", [
    ((3, 4, 7, 7, 24), 54), ((2, 13, 5, 5, 432), 192)])
def test_bf16_repeats_bit_for_bit_on_card(cuda, act, shape, cout):
    """Two calls on the same bfloat16 inputs give the same y, p and s2 bit
    for bit: no atomics, partial sums added in a fixed order."""
    x, w, a, b, _ = (v if isinstance(v, tuple) else
                     torch.from_numpy(v).to(cuda)
                     for v in _inputs(8, shape, cout))
    args = (x.bfloat16(), a, b, w) if act else (x.bfloat16(), w)
    fn = pw_stats.pw_act_conv_stats if act else pw_stats.pw_conv_stats
    first = fn(*args)
    second = fn(*args)
    torch.cuda.synchronize()
    for u, v in zip(first, second):
        assert torch.equal(u, v)
