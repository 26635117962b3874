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

With an eval BatchNorm (and a ReLU) as its epilogue (``ops/epilogue.py``)
the plain version is the plain conv followed by the model's affine, bit
for bit; on the card each body's epilogue equals its launch without one
followed by that affine, bit for bit.

JAX is imported inside the tests, so that the card tests (marker ``cuda``)
run on a machine without it:
``python -m pytest --noconftest -m cuda tests/test_torch_pointwise.py``.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from test_torch_dw_fused import bn_coefs, unfused
from x3d_tpu_torch import ops, variant_config
from x3d_tpu_torch.models import build_arch
from x3d_tpu_torch.ops import (epilogue, library, plain_versions, pointwise,
                               ring)
from x3d_tpu_torch.tools import profile_pointwise


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


# --------------------------------------------- the wg body's plan, on CPU

def _check_wg_plan(M, K, N, sms=pointwise.H100_SMS, plane=None):
    """The wg plan's invariants: an instantiated column tile, the column
    tiles cover N and none is empty, 64 rows a consumer warpgroup, the row
    tiles cover M (a strided call's: whole output rows of one frame, one
    column tile), the k-tiles cover K, a block for every row-tile slot and
    column tile, every row tile in some slot, the ring 2 .. 12 stages deep,
    shared memory as wg_smem lays it out and within the block's share of
    the SM, and the grid as wide as the card where the work allows."""
    p = pointwise.wg_plan(M, K, N, sms, plane)
    bn, nct = p["block_columns"], p["column_tiles"]
    assert bn in pointwise.WG_COLUMNS
    assert (nct - 1) * bn < N <= nct * bn
    assert nct == 1 or N % 8 == 0               # a row of y a bulk copy
    assert p["consumers"] in (1, 2)
    assert p["block_rows"] == 64 * p["consumers"]
    if plane is None:
        assert p["rows_per_tile"] == 0
        assert (p["tiles"] - 1) * p["block_rows"] < M <= p["tiles"] * p[
            "block_rows"]
    else:
        frames, H, W, sh, sw = plane
        Ho, Wo = -(-H // sh), -(-W // sw)
        r = p["rows_per_tile"]
        assert nct == 1 and 1 <= r <= Ho
        assert r * Wo <= p["block_rows"] and (r + 1) * Wo > p["block_rows"] \
            or r == Ho
        assert p["tiles"] == frames * -(-Ho // r) and M == frames * Ho * Wo
    assert (p["k_tiles"] - 1) * 64 < K <= p["k_tiles"] * 64
    assert p["blocks"] == p["slots"] * nct
    assert p["slots"] * p["tiles_per_block"] >= p["tiles"]
    assert p["slots"] <= p["tiles"]
    assert 2 <= p["stages"] <= pointwise.WG_MAX_STAGES
    assert p["smem_bytes"] == pointwise.wg_smem(
        K, bn, p["consumers"], p["stages"], p["w_resident"])
    assert p["smem_bytes"] <= min(227 * 1024,
                                  228 * 1024 // p["blocks_per_sm"] - 1024)
    if p["w_resident"]:
        assert p["k_tiles"] * bn * 128 <= min(
            pointwise.WG_RESIDENT_MAX,
            p["tiles_per_block"] * pointwise.WG_RESIDENT_PER_TILE)
    assert nct == 1 or bn <= pointwise.WG_SPLIT_BN
    assert p["blocks"] >= min(p["blocks_per_sm"] * sms - nct + 1,
                              p["tiles"] * nct)
    assert p["cluster"] == 1
    return p


def _variant_calls(variant, path):
    """(name, K, N, M, strides, (frames, H, W)) of every K7 call of
    X3D-<variant> on a
    path: serving one video (its views), evaluating TEST.BATCH_SIZE videos,
    or a training step at TRAIN.BATCH_SIZE clips (forward and dx)."""
    cfg = variant_config(variant)
    arch = build_arch(cfg)
    views = cfg.TEST.NUM_TEMPORAL_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    train = path == "training"
    clips = {"serving": views, "eval": cfg.TEST.BATCH_SIZE * views,
             "training": cfg.TRAIN.BATCH_SIZE}[path]
    crop = cfg.DATA.TRAIN_CROP_SIZE if train else cfg.DATA.TEST_CROP_SIZE
    found = profile_pointwise.cases(cfg, arch, clips, crop, train)
    if train:
        found = profile_pointwise.with_dx(found)
    out = []
    for name, shape, N, strides, _ in found:
        B, T, H, W, K = shape
        M = B * T * -(-H // strides[1]) * -(-W // strides[2])
        out.append((name, K, N, M, strides, (B * T, H, W)))
    return out


@pytest.mark.parametrize("path", ["serving", "eval"])
@pytest.mark.parametrize("variant", ["XS", "S", "M", "L", "XL"])
def test_wg_plan_holds_the_epilogue(variant, path):
    """Every wg call of an X3D-XS/S/M/L/XL eval forward with the BN
    epilogue (each takes one there but the stride-1 blocks' conv a): the
    plan keeps the coefficients, 8 bytes a column, in shared memory beside
    the rest (``wg_smem`` with the epilogue, within the block's share of
    the SM), with the tiling of the call without, the ring at most one
    stage shallower -- and at X3D-XS, S and M not one."""
    n = 0
    for name, K, N, M, strides, (frames, H, W) in _variant_calls(variant,
                                                                 path):
        if pointwise.pw_body(K, N, M, strides, width=W, height=H) != "wg":
            continue
        plane = _plane((frames, 1, H, W, K), strides)
        plain = pointwise.wg_plan(M, K, N, plane=plane)
        fused = pointwise.wg_plan(M, K, N, plane=plane, epilogue=True)
        bn, cons = fused["block_columns"], fused["consumers"]
        assert fused["smem_bytes"] == pointwise.wg_smem(
            K, bn, cons, fused["stages"], fused["w_resident"], True) == \
            pointwise.wg_smem(K, bn, cons, fused["stages"],
                              fused["w_resident"]) + 8 * bn
        assert fused["smem_bytes"] <= min(
            227 * 1024, 228 * 1024 // fused["blocks_per_sm"] - 1024)
        layout = ("stages", "smem_bytes")
        assert {k: v for k, v in fused.items() if k not in layout} == \
            {k: v for k, v in plain.items() if k not in layout}, name
        assert plain["stages"] - fused["stages"] in (
            (0,) if variant in ("XS", "S", "M") else (0, 1)), name
        n += 1
    assert n > 0


def _plane(shape, strides):
    """The input plane a strided call gives wg_plan (None at stride 1)."""
    if tuple(strides) == (1, 1, 1):
        return None
    return (shape[0] * shape[1], *shape[2:4], *strides[1:])


def _multigrid_phase(cfg, path):
    """The config of the long-cycle phase a "multigrid-<i>" path names
    (default factors; the phases do not depend on the epochs)."""
    from x3d_tpu_torch.train.multigrid import MultigridSchedule

    index = int(path.split("-")[1])
    return MultigridSchedule(cfg, 8, 5).phases[index].apply_to_config(cfg)


@pytest.mark.parametrize("path", ["serving", "eval", "training"]
                         + [f"multigrid-{i}" for i in range(4)])
@pytest.mark.parametrize("variant", ["XS", "S", "M", "L", "XL"])
def test_plan_at_every_x3d_shape(variant, path):
    """Every K7 call of X3D-XS/S/M/L/XL takes the body the rule names: wg
    where a row of x is a multiple of 16 bytes (2K % 16 == 0, a tensor
    map's rule), N fits the bulk stores and the call is not of the
    narrowest (K <= 32 with N <= 64), a strided projection where also its
    plane fits a tensor map's box, one column tile covers N, its pixels are
    whole lines (K >= 64) and its frames fill half a tile; pipe for the
    other even K; and each wg plan keeps its invariants.  At X3D-M, 43 of
    the 57 calls of a forward are wg; pipe takes the 8 at K = 54, 108,
    stage 2's 3 convs a and the projections of stages 2 to 4.  The
    "multigrid-<i>" paths are training steps at the long-cycle phases'
    (batch, T, S)."""
    cfg = variant_config(variant)
    arch = build_arch(cfg)
    views = cfg.TEST.NUM_TEMPORAL_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    if path.startswith("multigrid"):
        cfg, path = _multigrid_phase(cfg, path), "training"
    train = path == "training"
    clips = {"serving": views, "eval": cfg.TEST.BATCH_SIZE * views,
             "training": cfg.TRAIN.BATCH_SIZE}[path]
    crop = cfg.DATA.TRAIN_CROP_SIZE if train else cfg.DATA.TEST_CROP_SIZE
    found = profile_pointwise.cases(cfg, arch, clips, crop, train)
    if train:
        found = profile_pointwise.with_dx(found)
    n = {"wg": 0, "pipe": 0, "cuda_core": 0}
    for name, shape, N, strides, launches in found:
        B, T, H, W, K = shape
        M = B * T * -(-H // strides[1]) * -(-W // strides[2])
        body = pointwise.pw_body(K, N, M, strides, width=W, height=H)
        wg = ((2 * K) % 16 == 0
              and (N % 8 == 0 or (N % 2 == 0 and N <= 256))
              and not (K <= 32 and N <= 64)
              and (strides == (1, 1, 1)
                   or (N <= 256 and W <= 256 and -(-W // 2) <= 128
                       and K >= 64 and -(-H // 2) * -(-W // 2) >= 32)))
        assert body == ("wg" if wg else "pipe" if K % 2 == 0
                        else "cuda_core"), name
        n[body] += launches
        if body == "wg":
            _check_wg_plan(M, K, N, plane=_plane(shape, strides))
    if variant == "M" and path == "serving":
        assert n == {"wg": 43, "pipe": 14, "cuda_core": 0}


def test_plan_at_stage_5():
    """X3D-M's stage-5 conv c (7 840 rows, K 432 -> N 192): two column
    tiles of 96 (one of 192 leaves SMs idle at 64-row tiles) and 128-row
    tiles with W streamed, 62 x 2 blocks -- on an H100 faster than 132
    blocks of 64 rows with W resident (PERF.md §6)."""
    p = _check_wg_plan(7840, 432, 192)
    assert (p["block_rows"], p["block_columns"], p["column_tiles"]) == \
        (128, 96, 2)
    assert p["blocks"] == 124 and p["tiles"] == 62
    assert p["w_resident"] == 0 and p["stages"] >= 4


def test_plan_of_strided_projections():
    """A stride-2 projection's row tiles are whole output rows of one
    frame: X3D-M's stage-5 entry (7 x 7 outputs a frame) one frame a 64-row
    tile, stage 2's (56 wide) two rows a 128-row tile."""
    p = _check_wg_plan(160 * 49, 96, 192, plane=(160, 14, 14, 2, 2))
    assert (p["block_rows"], p["rows_per_tile"], p["tiles"]) == (64, 7, 160)
    p = _check_wg_plan(160 * 56 * 56, 24, 24, plane=(160, 112, 112, 2, 2))
    assert (p["block_rows"], p["rows_per_tile"]) == (128, 2)


@settings(max_examples=300, deadline=None, database=None)
@given(M=st.integers(1, 1 << 22), K=st.integers(1, 160).map(lambda k: 8 * k),
       N=st.integers(1, 640).map(lambda n: 2 * n),
       sms=st.sampled_from([132, 114, 8]))
def test_wg_plan_invariants(M, K, N, sms):
    """Over a sweep of rows, widths and SM counts the wg plan keeps its
    invariants wherever the rule gives the call to the wg body."""
    if pointwise.pw_body(K, N, M) == "wg":
        _check_wg_plan(M, K, N, sms)


@settings(max_examples=200, deadline=None, database=None)
@given(frames=st.integers(1, 300), H=st.integers(1, 130),
       W=st.integers(1, 300), K=st.integers(1, 60).map(lambda k: 8 * k),
       N=st.integers(1, 128).map(lambda n: 2 * n),
       s=st.sampled_from([(2, 2), (1, 2), (2, 1), (3, 3)]),
       sms=st.sampled_from([132, 8]))
def test_wg_plan_invariants_strided(frames, H, W, K, N, s, sms):
    """The same for strided calls over planes and strides."""
    sh, sw = s
    M = frames * -(-H // sh) * -(-W // sw)
    if pointwise.pw_body(K, N, M, (1, sh, sw), width=W, height=H) == "wg":
        _check_wg_plan(M, K, N, sms, plane=(frames, H, W, sh, sw))


@pytest.mark.parametrize("K,N,strides,aligned,plane,want", [
    (48, 108, (1, 1, 1), 16, 28, "wg"), (24, 108, (1, 1, 1), 16, 56, "wg"),
    (432, 192, (1, 1, 1), 16, 7, "wg"), (96, 432, (1, 1, 1), 16, 14, "wg"),
    (24, 54, (1, 1, 1), 16, 56, "pipe"),       # the narrowest calls
    (24, 24, (1, 1, 1), 16, 56, "pipe"), (54, 24, (1, 1, 1), 16, 56, "pipe"),
    (108, 48, (1, 1, 1), 16, 28, "pipe"),
    (96, 192, (1, 2, 2), 16, 14, "wg"),        # 7 x 7 outputs a frame
    (96, 192, (1, 2, 2), 16, 10, "pipe"),      # 5 x 5: under half a tile
    (48, 96, (1, 2, 2), 16, 28, "pipe"),       # pixels of 96 bytes
    (64, 96, (1, 2, 2), 16, 300, "pipe"),      # wider than a box
    (96, 432, (1, 2, 2), 16, 14, "pipe"),      # two column tiles
    (108, 216, (1, 2, 2), 16, 20, "pipe"),     # K = 108
    (48, 108, (1, 1, 1), 8, 28, "pipe"), (48, 108, (1, 1, 1), 4, 28, "pipe"),
    (48, 108, (1, 1, 1), 2, 28, "cuda_core"),
    (7, 5, (1, 1, 1), 16, 5, "cuda_core"),
    (48, 306, (1, 1, 1), 16, 5, "pipe"), (48, 55, (1, 1, 1), 16, 5, "pipe"),
])
def test_body_rule(K, N, strides, aligned, plane, want):
    """The wg body needs 2K % 16 == 0, 16-byte alignment, an N its stores
    take (a multiple of 8, or even within one column tile) and a call wider
    than the narrowest; a strided call also a square plane a tensor map's
    box holds, one column tile, pixels of whole lines and frames of half a
    tile; the pipe body an even K and 4-byte alignment; float32 runs on the
    CUDA cores."""
    assert pointwise.pw_body(K, N, 1000, strides, aligned, width=plane,
                             height=plane) == want
    assert pointwise.pw_body(K, N, 1000, strides, aligned, elem=4,
                             width=plane, height=plane) == "cuda_core"


def _tile_rows(p, plane, M, tile):
    """The first output row and the rows of row tile ``tile`` (wg_tile)."""
    if plane is None:
        m0 = tile * p["block_rows"]
        return m0, min(p["block_rows"], M - m0)
    _, H, W, sh, sw = plane
    Ho, Wo, r = -(-H // sh), -(-W // sw), p["rows_per_tile"]
    tpf = -(-Ho // r)
    frame, ho0 = tile // tpf, tile % tpf * r
    return (frame * Ho + ho0) * Wo, min(r, Ho - ho0) * Wo


def _wg_by_tiles(x, w, p, plane=None):
    """y = x @ w^T rebuilt in numpy in the wg body's order: each block
    (column tile ct, slot) walks row tiles slot, slot + slots, ...; each
    warpgroup's 64 rows of a tile are summed in float32 over the k-tiles in
    order, 16 k a wgmma step (all four steps of a k-tile: zeros fill it past
    K, and the rows and columns past the tile and N), the step's products
    added exactly and rounded once into the float32 sum.  x holds the rows
    the conv reads, in output order.  Returns y and how often each output
    was written."""
    M, K = x.shape
    N = w.shape[0]
    bn = p["block_columns"]
    y = np.zeros((M, N), np.float32)
    seen = np.zeros((M, N), np.int64)
    width = 64 * p["k_tiles"]
    for block in range(p["blocks"]):
        ct, slot = block % p["column_tiles"], block // p["column_tiles"]
        n0 = bn * ct
        for tile in range(slot, p["tiles"], p["slots"]):
            t0, t_rows = _tile_rows(p, plane, M, tile)
            for cg in range(p["consumers"]):
                m0, rows = t0 + 64 * cg, min(64, t_rows - 64 * cg)
                if rows <= 0:
                    continue
                xt = np.zeros((64, width), np.float64)
                wt = np.zeros((bn, width), np.float64)
                xt[:rows, :K] = x[m0:m0 + rows]
                wt[:min(bn, N - n0), :K] = w[n0:n0 + bn]
                acc = np.zeros((64, bn), np.float32)
                for k in range(0, width, 16):
                    step = xt[:, k:k + 16] @ wt[:, k:k + 16].T
                    acc = (acc + step).astype(np.float32)
                c = min(bn, N - n0)
                y[m0:m0 + rows, n0:n0 + c] = acc[:rows, :c]
                seen[m0:m0 + rows, n0:n0 + c] += 1
    return y, seen


@pytest.mark.parametrize("M,K,N,sms,plane", [
    (7840 // 20, 432, 192, 132, None),    # stage 5 c, fewer rows
    (300, 96, 432, 8, None),              # three column tiles of 144
    (1000, 24, 54, 4, None),              # N = 54 in one tile of 56
    (130, 216, 96, 132, None), (77, 40, 24, 3, None),
    (3 * 7 * 7, 96, 192, 8, (3, 14, 14, 2, 2)),    # a frame a tile
    (2 * 10 * 8, 24, 48, 5, (2, 19, 15, 2, 2)),    # odd planes
    (4 * 28 * 28, 48, 96, 6, (4, 56, 56, 2, 2)),   # two rows a tile
])
def test_wg_order_of_sums_rebuilds_the_product(M, K, N, sms, plane):
    """The wg body's schedule writes every output exactly once, and its
    order of sums (k-tiles in order, 16 k a step, float32 between steps)
    gives the plain product within float32 rounding."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(N, K)).astype(np.float32)
    p = _check_wg_plan(M, K, N, sms, plane)
    y, seen = _wg_by_tiles(x, w, p, plane)
    assert (seen == 1).all()
    want = x.astype(np.float64) @ w.astype(np.float64).T
    np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-4)


class _FailingWgLibrary:
    """A K7 library whose wg body fails at launch; it records the calls and
    checks that each passes as many arguments as its C signature takes."""

    def __init__(self):
        self.calls = []

    def x3d_pw_conv_wg(self, *args):
        assert len(args) == len(pointwise._SIGNATURES["x3d_pw_conv_wg"])
        self.calls.append("wg")
        return 1                                   # cudaErrorInvalidValue

    def __getattr__(self, name):                   # the other bodies'
        raise AssertionError(f"fell back to {name}")


@pytest.mark.parametrize("strides", [(1, 1, 1), (1, 2, 2)])
def test_failed_wg_launch_raises_without_fallback(strides):
    """A wg launch that returns an error raises; neither the pipe body nor
    the CUDA cores are asked to take over."""
    x, w, _ = _inputs(12, (2, 3, 4, 5, 24), 54, strides)
    xt, wt = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    plane = None if strides == (1, 1, 1) else (6, 4, 5, 2, 2)
    M = 6 * 4 * 5 if plane is None else 6 * 2 * 3
    lib = _FailingWgLibrary()
    with pytest.raises(RuntimeError, match=r"wg body.*CUDA error 1"):
        pointwise._launch(lib, "wg", xt, wt, strides, 0,
                          plan=pointwise.wg_plan(M, 24, 54, plane=plane))
    assert lib.calls == ["wg"]


# ------------------------------------------------ the wg body, on the card

def _body_counts(fn):
    before = dict(pointwise.pw_conv.body_launches)
    out = fn()
    return out, {k: v - before[k]
                 for k, v in pointwise.pw_conv.body_launches.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cout", [
    ((2, 3, 5, 7, 24), 54), ((3, 4, 7, 7, 54), 192), ((2, 5, 7, 7, 108), 432),
    ((2, 13, 5, 5, 432), 192), ((1, 7, 9, 11, 432), 54),
    ((2, 16, 7, 7, 432), 432), ((1, 3, 7, 9, 24), 192),
    ((10, 16, 14, 14, 96), 432), ((3, 16, 7, 7, 192), 432),
    # X3D-XL's stage-5 convs and their dx, whose odd tile counts over a
    # long K once sent the pipe body's B loads past its shared memory
    ((2, 16, 10, 10, 136), 630), ((2, 16, 10, 10, 630), 136),
    ((3, 16, 10, 10, 630), 280), ((2, 16, 10, 10, 280), 630),
    ((2, 16, 20, 20, 306), 136), ((2, 16, 39, 39, 162), 72)])
def test_bodies_match_plain_on_card(cuda, shape, cout):
    """bfloat16 at ragged M (no multiple of 64), N and K (K = 24, 54, 108,
    432 and X3D-XL's 136, 162, 280, 306, 630; N = 54, 192, 432 and XL's
    72, 136, 280, 630): K7 runs the body its rule names (counted once
    under it), within one bfloat16 ulp (2^-7) of the largest value of the
    plain version (float32 product of the same bfloat16 inputs), and each
    tensor-core body that takes the call, on the same inputs, within one
    ulp of the other."""
    x, w, _ = (torch.from_numpy(v).to(cuda) for v in _inputs(13, shape, cout))
    x, w = x.bfloat16(), w.bfloat16()
    K, M = shape[-1], x.numel() // shape[-1]
    body = pointwise.pw_body(K, cout, M)
    y, counts = _body_counts(lambda: pointwise.pw_conv(x, w))
    torch.cuda.synchronize()
    assert counts == {b: int(b == body) for b in counts}
    want = pointwise.pointwise_conv3d_reference(x.float(), w.float())
    scale = want.abs().max().item()
    assert (y.float() - want).abs().max().item() <= 2.0 ** -7 * scale
    lib = _build_lib()
    stream = torch.cuda.current_stream().cuda_stream
    bodies = {b: pointwise._launch(lib, b, x, w, (1, 1, 1), stream)
              for b in ("wg", "pipe") if b == body or b == "pipe"}
    torch.cuda.synchronize()
    assert torch.equal(bodies[body], y)
    diff = (bodies["pipe"].float() - y.float()).abs().max().item()
    assert diff <= 2.0 ** -7 * scale


def _build_lib():
    from x3d_tpu_torch.kernels import _build
    return _build.load("pointwise.cu", pointwise._SIGNATURES)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 4, 8])
@pytest.mark.parametrize("K,cout", [(48, 216), (432, 192)])
def test_unaligned_bases_take_the_planned_body_on_card(cuda, offset, K,
                                                       cout):
    """x starting 2, 4, 8 or 16 bytes into an allocation: K7 runs the body
    pw_body names for that alignment (wg at 16 bytes, pipe at 4 and 8,
    the CUDA cores at 2), within one bfloat16 ulp of the plain version."""
    shape = (2, 4, 7, 7, K)
    x, w, _ = (torch.from_numpy(v).to(cuda) for v in _inputs(14, shape, cout))
    flat = torch.empty(x.numel() + offset, dtype=torch.bfloat16, device=cuda)
    xs = flat[offset:].view(shape)
    xs.copy_(x)
    wb = w.bfloat16()
    body = pointwise.pw_body(K, cout, x.numel() // K, (1, 1, 1),
                             ring.align(xs, wb))
    assert body == {1: "cuda_core", 2: "pipe", 4: "pipe", 8: "wg"}[offset]
    y, counts = _body_counts(lambda: pointwise.pw_conv(xs, wb))
    torch.cuda.synchronize()
    assert counts[body] == 1 and sum(counts.values()) == 1
    want = pointwise.pointwise_conv3d_reference(xs.float(), wb.float())
    scale = want.abs().max().item()
    assert (y.float() - want).abs().max().item() <= 2.0 ** -7 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["M", "S"])
def test_wg_repeats_bit_for_bit_at_training_batches_on_card(cuda, variant):
    """Every wg call of an X3D-M (32 clips) and X3D-S (64 clips) training
    step, forward and dx, twice on the same inputs: the same bits (no
    atomics, no split-K)."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    for name, K, N, M, strides, plane in _variant_calls(variant, "training"):
        if pointwise.pw_body(K, N, M, strides, width=plane[2],
                             height=plane[1]) != "wg":
            continue
        x = torch.randn((plane[0], 1, plane[1], plane[2], K), generator=gen,
                        device="cuda").bfloat16()
        w = torch.randn((N, K), generator=gen, device="cuda").bfloat16()
        first = pointwise.pw_conv(x, w, strides)
        second = pointwise.pw_conv(x, w, strides)
        torch.cuda.synchronize()
        assert torch.equal(first, second), name
        del x, first, second


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cout,want", [
    ((2, 13, 21, 19, 24), 48, "pipe"), ((4, 16, 14, 14, 96), 192, "wg"),
    ((2, 16, 112, 112, 24), 24, "pipe"), ((3, 5, 9, 7, 56), 24, "pipe"),
    ((64, 13, 10, 10, 96), 192, "pipe"), ((2, 3, 5, 5, 96), 432, "pipe"),
    ((2, 16, 28, 28, 96), 96, "wg"), ((3, 4, 13, 11, 64), 200, "wg"),
    ((2, 3, 130, 129, 64), 24, "wg")])
def test_strided_projection_on_card(cuda, shape, cout, want):
    """A stride-(1, 2, 2) projection reads its rows in place -- on the wg
    body through a rank-4 tensor map where its rule allows (pixels of
    whole lines, frames of half a tile, one column tile; output rows of 65
    values need a 128-row tile), else on the pipe body's gathered rows --
    within one bfloat16 ulp of the plain version on the subsampled input;
    the pipe body on the same inputs within one ulp of it."""
    strides = (1, 2, 2)
    x, w, _ = (torch.from_numpy(v).to(cuda)
               for v in _inputs(16, shape, cout, strides))
    x, w = x.bfloat16(), w.bfloat16()
    M = shape[0] * shape[1] * -(-shape[2] // 2) * -(-shape[3] // 2)
    body = pointwise.pw_body(shape[-1], cout, M, strides, width=shape[3],
                             height=shape[2])
    assert body == want
    y, counts = _body_counts(lambda: pointwise.pw_conv(x, w, strides))
    torch.cuda.synchronize()
    assert counts == {b: int(b == body) for b in counts}
    pipe = pointwise._launch(_build_lib(), "pipe", x, w, strides,
                             torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    want = pointwise.pointwise_conv3d_reference(x.float(), w.float(),
                                                strides)
    scale = want.abs().max().item()
    assert (y.float() - want).abs().max().item() <= 2.0 ** -7 * scale
    assert (pipe.float() - y.float()).abs().max().item() <= 2.0 ** -7 * scale


@pytest.mark.cuda
def test_wg_smem_matches_the_kernel_on_card(cuda):
    """wg_smem (Python) counts the same bytes as the kernel's layout, for
    every plan of X3D-M's serving and training calls."""
    lib = _build_lib()
    for path in ("serving", "training"):
        for _, K, N, M, strides, plane in _variant_calls("M", path):
            if pointwise.pw_body(K, N, M, strides, width=plane[2],
                                 height=plane[1]) != "wg":
                continue
            p = pointwise.wg_plan(M, K, N, plane=_plane(
                (plane[0], 1) + plane[1:3], strides))
            assert lib.x3d_pw_conv_wg_smem(
                K, p["block_columns"], p["consumers"], p["stages"],
                p["w_resident"]) == p["smem_bytes"]


# ------------------------------------------------------ the BN epilogue


@pytest.mark.parametrize("strides,relu", [((1, 1, 1), False),
                                          ((1, 1, 1), True),
                                          ((1, 2, 2), False)],
                         ids=["bn", "bn_relu", "strided_bn"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_epilogue_plain_equals_the_unfused_sequence(dtype, strides, relu):
    """K7 + bn (bn_c, bn_r), + bn + ReLU (bn_a at the stage entries,
    bn_5) and strided + bn (the projections) on the CPU: the wrapper, its
    op and the differentiable entry with autograd off (the kernel's route
    and ``plain_versions()``) give the plain conv then the model's affine
    (then the ReLU), bit for bit; the launch log names the epilogue and
    counts its work."""
    x, w, _ = _inputs(41, (2, 3, 7, 6, 24), 54, strides)
    x, w = torch.from_numpy(x).to(dtype), torch.from_numpy(w)
    mul, add = bn_coefs(42, 54)
    want = unfused(pointwise.pw_conv(x, w, strides), mul, add, relu)
    with torch.no_grad(), ops.launch_log() as log:
        calls = [pointwise.pw_conv(x, w, strides, "fwd", mul, add, relu),
                 library.pw_conv(x, w, list(strides), mul, add, relu),
                 pointwise.pointwise_conv3d(x, w, strides, None, mul, add,
                                            relu)]
        with plain_versions():
            calls.append(pointwise.pointwise_conv3d(x, w, strides, None,
                                                    mul, add, relu))
    for got in calls:
        assert got.dtype == dtype and torch.equal(got, want)
    kind = "bn_relu" if relu else "bn"
    assert [r["epilogue"] for r in log] == [kind] * 3
    M = want.numel() // 54
    work = pointwise.cost(M, 24, 54, x.element_size())
    assert (log[0]["bytes"], log[0]["flops"]) == \
        (work[0] + 8 * 54, work[1] + (3 if relu else 2) * want.numel())


def test_epilogue_is_forward_only():
    """An epilogue where autograd would record the call raises (it has no
    backward), and so does half of one or a ReLU without one."""
    x, w, _ = _inputs(43, (2, 3, 4, 5, 8), 16)
    x, w = torch.from_numpy(x), torch.from_numpy(w).requires_grad_()
    mul, add = bn_coefs(44, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        pointwise.pointwise_conv3d(x, w, (1, 1, 1), None, mul, add)
    with pytest.raises(ValueError, match="mul and add"):
        pointwise.pw_conv(x, w.detach(), (1, 1, 1), "fwd", mul, None)
    with pytest.raises(ValueError, match="ReLU"):
        pointwise.pw_conv(x, w.detach(), (1, 1, 1), "fwd", relu=True)


@pytest.mark.parametrize("relu", [False, True], ids=["bn", "bn_relu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_epilogue_op_passes_opcheck(dtype, relu):
    """``x3d::pw_conv`` with the epilogue's arguments, strided: its schema,
    and its fake's output against the real one's shape, dtype and strides
    (``torch.library.opcheck``)."""
    x, w, _ = _inputs(45, (2, 5, 7, 9, 8), 16, (1, 2, 2))
    mul, add = bn_coefs(46, 16)
    torch.library.opcheck(
        library.pw_conv, (torch.from_numpy(x).to(dtype),
                          torch.from_numpy(w).to(dtype), [1, 2, 2], mul, add,
                          relu),
        test_utils=("test_schema", "test_faketensor"))


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True], ids=["bn", "bn_relu"])
@pytest.mark.parametrize("body,dtype,shape,cout,strides", [
    ("wg", torch.bfloat16, (2, 5, 14, 14, 96), 432, (1, 1, 1)),
    ("wg", torch.bfloat16, (2, 5, 28, 28, 48), 54, (1, 1, 1)),
    ("wg", torch.bfloat16, (2, 5, 14, 14, 96), 192, (1, 2, 2)),
    ("pipe", torch.bfloat16, (2, 5, 14, 14, 54), 24, (1, 1, 1)),
    ("pipe", torch.bfloat16, (2, 5, 13, 13, 24), 54, (1, 2, 2)),
    ("cuda_core", torch.bfloat16, (2, 3, 7, 7, 7), 54, (1, 1, 1)),
    ("cuda_core", torch.float32, (2, 5, 14, 14, 96), 432, (1, 1, 1)),
    ("cuda_core", torch.float32, (2, 5, 13, 13, 24), 54, (1, 2, 2))])
def test_epilogue_matches_the_unfused_launch_on_card(cuda, body, dtype,
                                                     shape, cout, strides,
                                                     relu):
    """Each body's epilogue (wg, pipe; the CUDA cores in float32 and at an
    odd K), at stride 1 and 2 and ragged column tiles: y equals the same
    body's launch without one followed by the plain epilogue
    (``torch.addcmul``, as the model's affine), bit for bit; the wrapper
    counts the launch under its kind."""
    x, w, _ = (torch.from_numpy(v).to(cuda)
               for v in _inputs(47, shape, cout, strides))
    x, w = x.to(dtype), w.to(dtype)
    mul, add = (v.to(cuda) for v in bn_coefs(48, cout))
    M = shape[0] * shape[1] * -(-shape[2] // strides[1]) \
        * -(-shape[3] // strides[2])
    stream = torch.cuda.current_stream().cuda_stream
    y0 = pointwise._launch(_build_lib(), body, x, w, strides, stream)
    y1 = pointwise._launch(
        epilogue.library("pointwise.cu", pointwise._SIGNATURES, (mul, add)),
        body, x, w, strides, stream, bn=epilogue.pointers((mul, add), relu))
    kind = "bn_relu" if relu else "bn"
    before = dict(pointwise.pw_conv.epilogue_launches)
    y2 = pointwise.pw_conv(x, w, strides, "fwd", mul, add, relu)
    torch.cuda.synchronize()
    assert pointwise.pw_conv.epilogue_launches == \
        before | {kind: before[kind] + 1}
    want = epilogue.reference(y0, mul, add, relu)
    assert torch.equal(y1, want)
    if pointwise.pw_body(shape[-1], cout, M, strides, elem=x.element_size(),
                         width=shape[3], height=shape[2]) == body:
        assert torch.equal(y2, want)
