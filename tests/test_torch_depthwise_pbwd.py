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
even taps keep K4's two entry points.

JAX is imported inside the tests, so that the card tests (marker ``cuda``)
run on a machine without it:
``python -m pytest --noconftest -m cuda tests/test_torch_depthwise_pbwd.py``.
"""

import numpy as np
import pytest
import torch

from x3d_tpu_torch.ops import depthwise

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
    before = depthwise.depthwise_conv3d_pbwd.launches
    du, dk = depthwise.depthwise_conv3d_pbwd(u, gy, k)
    torch.cuda.synchronize()
    assert depthwise.depthwise_conv3d_pbwd.launches == before + 1
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
