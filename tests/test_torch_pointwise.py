"""The plain 1x1x1 conv (kernel K7) against the JAX package, its routing,
and the kernel against its plain version on the card.

On the CPU the wrapper runs its plain version (``F.linear``).  The
differentiable op -- forward, dx (the same product on the cotangent and the
transposed weight) and dW (the float32 contraction) -- is held against the
JAX package's ``pw_batchminor.pw_conv_bm``, a Pallas kernel with its own
backward rule, in interpret mode, at channel counts that are no multiples
of 8; a strided projection against ``PointwiseConv3D(strides=(1, 2, 2))``.

Tolerances (float32, sums in another order): y, dx and dW atol 1e-5 with
rtol 1e-5.

JAX is imported inside the tests, so that the card tests (marker ``cuda``)
run on a machine without it:
``python -m pytest --noconftest -m cuda tests/test_torch_pointwise.py``.
"""

import numpy as np
import pytest
import torch

from x3d_tpu_torch.ops import plain_versions, pointwise


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, shape, cout, strides=(1, 1, 1)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = (0.3 * rng.normal(size=(cout, shape[-1]))).astype(np.float32)
    out = (shape[0], shape[1], -(-shape[2] // strides[1]),
           -(-shape[3] // strides[2]), cout)
    g = rng.normal(size=out).astype(np.float32)
    return x, w, g


def _port(x, w, g, strides=(1, 1, 1)):
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = pointwise.pointwise_conv3d(xt, wt, strides)
    dx, dw = torch.autograd.grad((y * torch.from_numpy(g)).sum(), [xt, wt])
    return y.detach().numpy(), dx.numpy(), dw.numpy()


def _assert_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cin,cout", [(6, 10), (24, 54), (54, 24), (7, 5)])
def test_matches_jax_kernel_interpret(cin, cout):
    import jax
    import jax.numpy as jnp
    from x3d_tpu.ops import pw_batchminor

    x, w, g = _inputs(0, (2, 3, 4, 5, cin), cout)

    def run(x, w):
        y, vjp = jax.vjp(
            lambda x, w: pw_batchminor.pw_conv_bm(x, jnp.transpose(w)), x, w)
        return (y, *vjp(jnp.asarray(g)))

    old = pw_batchminor.INTERPRET
    pw_batchminor.INTERPRET = True
    try:
        want = jax.jit(run)(x, w)
    finally:
        pw_batchminor.INTERPRET = old
    _assert_close(_port(x, w, g), want)


@pytest.mark.parametrize("hw", [(8, 8), (7, 5)])
def test_strided_projection_matches_jax_module(hw):
    """A stride-(1, 2, 2) 1x1x1 conv reads every second row and column, on
    even and on odd planes; its dx is zero at the positions it skips."""
    import jax
    import jax.numpy as jnp
    from x3d_tpu.ops.pointwise import PointwiseConv3D

    strides = (1, 2, 2)
    x, w, g = _inputs(1, (2, 3, *hw, 6), 10, strides)
    module = PointwiseConv3D(features=10, strides=strides, impl="conv")

    def run(x, w):
        kernel = jnp.transpose(w).reshape(1, 1, 1, 6, 10)
        y, vjp = jax.vjp(
            lambda x, k: module.apply({"params": {"kernel": k}}, x), x,
            kernel)
        dx, dk = vjp(jnp.asarray(g))
        return y, dx, jnp.transpose(dk.reshape(6, 10))

    got = _port(x, w, g, strides)
    _assert_close(got, jax.jit(run)(x, w))
    assert got[0].shape == g.shape
    skipped = np.ones(x.shape[2:4], bool)
    skipped[::2, ::2] = False
    assert not got[1][:, :, skipped].any()


def test_bf16_rounds_once():
    """bfloat16 inputs: the product is summed in float32 and rounded once,
    as ``F.linear`` does (the serving probabilities depend on it)."""
    x, w, _ = _inputs(2, (2, 3, 4, 5, 24), 54)
    xb = torch.from_numpy(x).bfloat16()
    wt = torch.from_numpy(w)
    y = pointwise.pw_conv(xb, wt)
    assert y.dtype == torch.bfloat16
    want = (xb.double() @ wt.bfloat16().double().t()).bfloat16()
    # the float32 sum may land one ulp from the exact sum's rounding
    diff = (y.float() - want.float()).abs()
    assert (diff <= 2.0 ** -7 * want.float().abs() + 1e-6).all()
    assert (diff == 0).float().mean() > 0.99


@pytest.mark.parametrize("shape,bias,strides,want", [
    ((2, 4, 8, 8, 24), False, (1, 1, 1), True),      # a bulk conv
    ((2, 4, 8, 8, 24), False, (1, 2, 2), True),      # a strided projection
    ((2, 1, 2, 2, 24), False, (1, 2, 2), False),     # one position left
    ((2, 1, 1, 1, 24), False, (1, 1, 1), False),     # SE on the pooled map
    ((2, 4, 8, 8, 24), True, (1, 1, 1), False),      # a bias: SE, head
    ((2, 24), False, (1, 1, 1), False),              # 2-D: the head
])
def test_routing_predicate(shape, bias, strides, want):
    assert pointwise.routes_to_kernel(shape, bias, strides) is want


def _tiny_model(train):
    from x3d_tpu_torch import variant_config
    from x3d_tpu_torch.models import build_arch, create_model

    cfg = variant_config("XS")
    cfg.NETWORK.C1_CHANNELS = 4
    cfg.NETWORK.DEPTH_FACTOR = 0.34
    cfg.NETWORK.DROPOUT_RATE = 0.0
    model = create_model(cfg, dtype=torch.float32, device="cpu")
    model.train(train)
    return model, build_arch(cfg)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_every_bulk_conv_of_the_model_takes_the_kernel_route(monkeypatch,
                                                              train):
    """No bulk 1x1x1 conv of the model reaches ``F.linear`` directly: each
    goes through ``pw_conv`` (K7 on a CUDA tensor), or through K5/K6 in the
    training step's stride-1 blocks.  Within ``plain_versions()`` none
    does."""
    calls = []
    real = pointwise.pw_conv

    def counting(x, weight, strides=(1, 1, 1)):
        calls.append((tuple(x.shape), tuple(strides)))
        return real(x, weight, strides)

    monkeypatch.setattr(pointwise, "pw_conv", counting)
    model, arch = _tiny_model(train)
    x = torch.randn(2, 4, 32, 32, 3,
                    generator=torch.Generator().manual_seed(0))
    model(x, return_logits=True)
    blocks = [b for stage in arch.stages for b in stage]
    entries = [b for b in blocks if b.stride != 1]
    projections = len(arch.stages)
    # eval: every block's convs a and c; training: K5/K6 take the stride-1
    # blocks', K7 keeps the stage entries'; plus the projections and conv_5
    want = (2 * len(entries if train else blocks)) + projections + 1
    assert len(calls) == want
    assert sum(s != (1, 1, 1) for _, s in calls) == projections
    calls.clear()
    with plain_versions():
        model(x, return_logits=True)
    assert not calls


def test_shapes_are_checked():
    x, w, _ = _inputs(3, (2, 3, 4, 5, 8), 16)
    with pytest.raises(ValueError, match="Cout, Cin"):
        pointwise.pw_conv(torch.from_numpy(x), torch.from_numpy(w.T))
    with pytest.raises(ValueError, match="strides"):
        pointwise.pw_conv(torch.from_numpy(x), torch.from_numpy(w),
                          (2, 1, 1))


def test_non_cpu_tensor_never_falls_back():
    x, w, _ = _inputs(4, (2, 3, 4, 5, 8), 16)
    with pytest.raises(ValueError, match="CUDA"):
        pointwise.pw_conv(torch.from_numpy(x).to("meta"),
                          torch.from_numpy(w).to("meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout,strides", [
    ((2, 3, 4, 5, 8), 16, (1, 1, 1)), ((3, 4, 7, 7, 24), 54, (1, 1, 1)),
    ((2, 13, 5, 5, 432), 192, (1, 1, 1)), ((2, 13, 10, 10, 96), 216,
                                           (1, 1, 1)),
    ((2, 13, 21, 19, 24), 48, (1, 2, 2)), ((1, 1, 3, 1, 5), 70, (1, 1, 1)),
    ((2, 3, 4, 5, 8), 15, (1, 1, 1)), ((3, 5, 9, 7, 54), 24, (1, 2, 2)),
    # K = 54 and 108: rows of 108 and 216 bytes (4- and 8-byte granules)
    ((2, 4, 7, 7, 54), 24, (1, 1, 1)), ((2, 4, 7, 7, 54), 48, (1, 1, 1)),
    ((2, 4, 7, 7, 108), 24, (1, 1, 1)), ((2, 4, 7, 7, 108), 48, (1, 1, 1)),
    # a strided projection at K = 108
    ((2, 13, 10, 10, 108), 216, (1, 2, 2))])
def test_kernel_matches_plain_on_card(cuda, dtype, shape, cout, strides):
    """K7's forward, dx and dW against the plain version on the same
    inputs (float32 matmul, TF32 off): float32 within 1e-5 of the largest
    value; bfloat16 within one ulp (2^-7) of the largest value.  Even and
    odd channel counts: bfloat16 with an even Cin runs on the tensor cores,
    everything else on the CUDA cores."""
    x, w, g = (torch.from_numpy(v).to(cuda)
               for v in _inputs(5, shape, cout, strides))
    x, g = x.to(dtype).requires_grad_(), g.to(dtype)
    w.requires_grad_()
    before = pointwise.pw_conv.launches
    y = pointwise.pointwise_conv3d(x, w, strides)
    got = (y, *torch.autograd.grad((y.float() * g.float()).sum(), [x, w]))
    torch.cuda.synchronize()
    assert pointwise.pw_conv.launches == before + 2      # forward and dx
    with plain_versions():
        yr = pointwise.pointwise_conv3d(x, w, strides)
        want = (yr, *torch.autograd.grad((yr.float() * g.float()).sum(),
                                         [x, w]))
    assert pointwise.pw_conv.launches == before + 2
    assert y.dtype == dtype and got[1].dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    for a, b in zip(got, want):
        scale = max(1.0, b.float().abs().max().item())
        assert (a.float() - b.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 4, 8])
def test_unaligned_base_on_card(cuda, offset):
    """x starting 2, 4, 8 or 16 bytes into an allocation: the copy granule
    is picked from the base pointers at launch (an odd element offset
    takes the CUDA-core route); y within one bfloat16 ulp of the largest
    value of the plain version's."""
    shape, cout = (2, 4, 7, 7, 432), 48
    x, w, _ = (torch.from_numpy(v).to(cuda) for v in _inputs(9, shape, cout))
    flat = torch.empty(x.numel() + offset, dtype=torch.bfloat16, device=cuda)
    xs = flat[offset:].view(shape)
    xs.copy_(x)
    y = pointwise.pw_conv(xs, w)
    torch.cuda.synchronize()
    want = pointwise.pointwise_conv3d_reference(xs.float(), w.bfloat16()
                                                .float())
    scale = want.abs().max().item()
    assert (y.float() - want).abs().max().item() <= 2.0 ** -7 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cout,strides", [
    ((3, 4, 7, 7, 24), 54, (1, 1, 1)), ((2, 13, 10, 10, 108), 216, (1, 2, 2))])
def test_bf16_repeats_bit_for_bit_on_card(cuda, shape, cout, strides):
    x, w, _ = (torch.from_numpy(v).to(cuda)
               for v in _inputs(10, shape, cout, strides))
    x = x.bfloat16()
    first, second = pointwise.pw_conv(x, w, strides), \
        pointwise.pw_conv(x, w, strides)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
