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

JAX is imported inside the tests, so that the card tests (marker ``cuda``)
run on a machine without it:
``python -m pytest --noconftest -m cuda tests/test_torch_dw_fused_bwd.py``.
"""

import numpy as np
import pytest
import torch

from x3d_tpu_torch.ops import dw_fused


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
    ((3, 5, 6, 5, 7), (3, 3, 3)), ((2, 5, 4, 9, 3), (5, 3, 3))])
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


def test_non_cpu_tensor_never_falls_back():
    args, cots = _inputs(4, (2, 3, 4, 4, 4), (3, 3, 3))
    t = [torch.from_numpy(v).to("meta") for v in args + cots]
    x, a, b, k, gy, gp, gs2 = t
    with pytest.raises(ValueError, match="CUDA"):
        dw_fused.dw_bn_act_conv_bwd(x, a, b, k, x, gy, gp, gs2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kdims", [
    ((3, 5, 6, 5, 7), (3, 3, 3)), ((2, 5, 4, 9, 3), (5, 3, 3)),
    ((3, 6, 9, 17, 70), (3, 3, 3)), ((2, 16, 7, 7, 432), (3, 3, 3))])
def test_kernel_matches_plain_on_card(cuda, dtype, shape, kdims):
    """The plain version on the same inputs rounds u and g to x's dtype as
    the kernel does and sums in float32 (cuDNN, TF32 off), so the two differ
    by the order of the sums: dk, dzs, duu within 1e-5 of the matching sums
    of absolute values; dx atol 1e-4 in float32, and in bfloat16 within
    2e-2 of its largest |dx| (one rounding of dx)."""
    args, cots = _inputs(5, shape, kdims)
    x, a, b, k = (torch.from_numpy(v).to(cuda) for v in args)
    gy, gp, gs2 = (torch.from_numpy(v).to(cuda) for v in cots)
    x, k, gy = x.to(dtype), k.to(dtype), gy.to(dtype)
    y = dw_fused.reference(x, a, b, k)[0]
    before = dw_fused.dw_bn_act_conv_bwd.launches
    got = dw_fused.dw_bn_act_conv_bwd(x, a, b, k, y, gy, gp, gs2)
    torch.cuda.synchronize()
    assert dw_fused.dw_bn_act_conv_bwd.launches == before + 1
    want = dw_fused.bwd_reference(x, a, b, k, y, gy, gp, gs2)
    tol_dx = 1e-4 if dtype == torch.float32 else \
        2e-2 * want[0].float().abs().max().item()
    assert got[0].dtype == dtype
    assert (got[0].float() - want[0].float()).abs().max().item() <= tol_dx
    for g, w, s in zip(got[1:], want[1:],
                       dw_fused.bwd_abs_sums(x, a, b, k, y, gy, gp, gs2)):
        assert ((g - w).abs() <= 1e-5 * s + 1e-6).all()

