"""The port's depthwise conv against the JAX package, and kernel K1 against
its plain version on the card.

On the CPU the wrapper runs its plain version (explicit ``F.pad`` +
``F.conv3d(groups=C)``); it is held against JAX's XLA lowering at stride 1
and (1,2,2), odd and even H/W (7 and 8 pin the high-side TF-SAME pad) and
the stem's 5×1×1 with pad (2,2), and at stride 1 also against the
batch-minor and dense-row Pallas kernels in interpret mode.  Tolerance:
float32, atol 1e-5 / rtol 1e-5 (the same sums in another order).

K1 has three bodies on the card: :func:`depthwise.fwd_body` sends the
stem's k×1×1 conv to the temporal body, the stride-2 stage entries (and any
3x3 conv at stride 1 or 2) to the ring body and every other geometry to the
generic body.  Their launch plans are pure Python and are checked here at
every stem and stage-entry shape of X3D-XS to XL; the ring body's staging map
(which staged cell feeds which output tap) is written out in numpy and held
against the plain version (float32, atol 1e-5).

With an eval BatchNorm (and a ReLU) as its epilogue (``ops/epilogue.py``)
the plain version is the plain conv followed by the model's affine, bit
for bit; on the card each body's epilogue equals its launch without one
followed by that affine, bit for bit.

JAX is imported inside the tests, so that the card tests (marker ``cuda``)
run on a machine without it:
``python -m pytest --noconftest -m cuda tests/test_torch_depthwise.py``.
"""

import ctypes

import numpy as np
import pytest
import torch

from test_torch_dw_fused import bn_coefs, multigrid_phases, unfused
from x3d_tpu_torch import ops, variant_config
from x3d_tpu_torch.models import build_arch
from x3d_tpu_torch.ops import (depthwise, epilogue, library, plain_versions,
                               ring)

SAME_CASES = [
    ((2, 4, 7, 7, 5), (3, 3, 3), (1, 1, 1), "SAME"),
    ((2, 4, 8, 8, 5), (3, 3, 3), (1, 1, 1), "SAME"),
    ((2, 4, 7, 7, 5), (3, 3, 3), (1, 2, 2), "SAME"),
    ((2, 4, 8, 8, 5), (3, 3, 3), (1, 2, 2), "SAME"),
    ((2, 6, 5, 5, 4), (5, 1, 1), (1, 1, 1), ((2, 2), (0, 0), (0, 0))),
]


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
    x = rng.normal(size=shape).astype(np.float32)
    k = (0.3 * rng.normal(size=kdims + (1, shape[-1]))).astype(np.float32)
    return x, k


def _port(x, k, strides=(1, 1, 1), padding="SAME"):
    return depthwise.depthwise_conv3d(torch.from_numpy(x), torch.from_numpy(k),
                                      strides, padding).numpy()


@pytest.mark.parametrize("shape,kdims,strides,padding", SAME_CASES)
def test_matches_jax_xla(shape, kdims, strides, padding):
    from x3d_tpu.ops.depthwise import depthwise_conv3d as jax_dw

    x, k = _inputs(0, shape, kdims)
    want = np.asarray(jax_dw(x, k, strides, padding, impl="xla"))
    got = _port(x, k, strides, padding)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kdims", [(3, 3, 3), (5, 1, 1)])
def test_matches_jax_pallas_kernels(kdims):
    from x3d_tpu.ops import dw_batchminor, pallas_dw

    x, k = _inputs(1, (2, 5, 7, 8, 6), kdims)
    old = dw_batchminor.INTERPRET, pallas_dw.INTERPRET
    dw_batchminor.INTERPRET = pallas_dw.INTERPRET = True
    try:
        want_bm = np.asarray(dw_batchminor.dw_conv_bm(x, k, kdims))
        want_rows = np.asarray(pallas_dw.depthwise_conv3d_pallas(x, k))
    finally:
        dw_batchminor.INTERPRET, pallas_dw.INTERPRET = old
    got = _port(x, k)
    np.testing.assert_allclose(got, want_bm, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_rows, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [5, 7, 8, 14, 112])
@pytest.mark.parametrize("stride", [1, 2])
def test_same_pads_match_jax(size, stride):
    from x3d_tpu.ops.depthwise import same_pads as jax_same_pads

    assert depthwise.same_pads(size, 3, stride) == \
        jax_same_pads(size, 3, stride)
    if stride == 2 and size % 2 == 0:
        assert depthwise.same_pads(size, 3, stride) == (0, 1)


def test_cpu_call_takes_plain_version_without_launching():
    x, k = _inputs(2, (1, 3, 4, 4, 3), (3, 3, 3))
    before = depthwise.depthwise_conv3d.launches
    _port(x, k)
    assert depthwise.depthwise_conv3d.launches == before


def test_non_cpu_tensor_never_falls_back():
    x = torch.zeros((1, 3, 4, 4, 3), device="meta")
    k = torch.zeros((3, 3, 3, 1, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        depthwise.depthwise_conv3d(x, k)


# --------------------------------------------------- K1's bodies and plans

def _model_convs(variant, B, train=False, cfg=None):
    """(name, shape, kdims, strides, pads) of each K1 launch of a forward of
    ``variant`` (at ``cfg``'s geometry where given) at B clips: the stem's
    conv_t and the four stage entries."""
    cfg = cfg or variant_config(variant)
    arch = build_arch(cfg)
    T = cfg.DATA.TEMP_DURATION
    S = (cfg.DATA.TRAIN_CROP_SIZE if train else cfg.DATA.TEST_CROP_SIZE) // 2
    kt = arch.temp_filter
    convs = [("stem", (B, T, S, S, arch.conv1_dim), (kt, 1, 1), (1, 1, 1),
              ((kt // 2, kt // 2), (0, 0), (0, 0)))]
    for si, blocks in enumerate(arch.stages):
        shape = (B, T, S, S, blocks[0].inner_channels)
        kdims = (arch.temp_kernel, 3, 3)
        convs.append((f"stage{si + 2}", shape, kdims, (1, 2, 2),
                      depthwise._resolve_pads(shape, kdims, (1, 2, 2),
                                              "SAME")))
        S = -(-S // 2)
    return convs


def _batches(variant):
    """The batches that run a variant's K1 launches: a video's views and
    eight videos' (serving), the eval batch and the training batch."""
    cfg = variant_config(variant)
    views = cfg.TEST.NUM_TEMPORAL_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    return sorted({(views, False), (8 * views, False),
                   (cfg.TEST.BATCH_SIZE * views, False),
                   (cfg.TRAIN.BATCH_SIZE, True)})


MODEL_CONVS = [(f"{v}-B{B}-{name}", shape, kdims, strides, pads)
               for v in ("XS", "S", "M", "L", "XL")
               for B, train in _batches(v)
               for name, shape, kdims, strides, pads in _model_convs(
                   v, B, train)]

# every variant's K1 launches at its long-cycle multigrid phases (default
# factors: batches 2 to 8 times the config's, X3D-XS down to 1 frame, the
# stems of 1 to 4 frames under 5 taps) that MODEL_CONVS does not hold
MULTIGRID_CONVS = list({
    shape + (name[-5:],): (f"{v}-mg{i}-B{c.TRAIN.BATCH_SIZE}-{name}", shape,
                           kdims, strides, pads)
    for v in ("XS", "S", "M", "L", "XL") for i, c in multigrid_phases(v)
    for name, shape, kdims, strides, pads in _model_convs(
        v, c.TRAIN.BATCH_SIZE, True, c)
    if shape not in {m[1] for m in MODEL_CONVS}}.values())


@pytest.mark.parametrize("name,shape,kdims,strides,pads",
                         MODEL_CONVS + MULTIGRID_CONVS,
                         ids=[c[0] for c in MODEL_CONVS + MULTIGRID_CONVS])
def test_fwd_body_takes_new_bodies_at_every_model_conv(name, shape, kdims,
                                                       strides, pads):
    """Every K1 launch of every variant, at its config and its multigrid
    phases, takes a new body: the stem the temporal body (X3D-XS's too,
    whose 4 frames are fewer than its 5 taps, and every stem of 1 to 4
    frames),
    the stage entries the ring body (at even planes, pads (0, 1), and odd
    ones, (1, 1))."""
    want = "temporal" if name.endswith("stem") else "ring"
    assert depthwise.fwd_body(kdims, strides, pads) == want
    if want == "ring":
        assert pads[1] == ((1, 1) if shape[2] % 2 else (0, 1))


@pytest.mark.parametrize("kdims,strides,pads,want", [
    ((3, 1, 1), (1, 1, 1), ((1, 1), (0, 0), (0, 0)), "temporal"),
    ((1, 1, 1), (1, 1, 1), ((0, 0), (0, 0), (0, 0)), "temporal"),
    ((4, 1, 1), (1, 1, 1), ((0, 3), (0, 0), (0, 0)), "temporal"),
    ((5, 1, 1), (1, 1, 1), ((2, 2), (1, 1), (0, 0)), "generic"),
    ((5, 1, 1), (2, 1, 1), ((2, 2), (0, 0), (0, 0)), "generic"),
    ((7, 1, 1), (1, 1, 1), ((3, 3), (0, 0), (0, 0)), "generic"),
    ((3, 3, 3), (1, 1, 1), ((1, 1), (1, 1), (1, 1)), "ring"),
    ((1, 3, 3), (1, 2, 2), ((0, 0), (0, 1), (0, 1)), "ring"),
    ((5, 3, 3), (1, 2, 2), ((2, 2), (1, 1), (1, 1)), "ring"),
    ((3, 3, 3), (1, 1, 1), ((0, 0), (0, 0), (0, 0)), "ring"),
    ((3, 3, 3), (1, 2, 2), ((3, 0), (1, 1), (1, 1)), "generic"),
    ((3, 3, 3), (1, 2, 2), ((1, 1), (2, 2), (1, 1)), "generic"),
    ((3, 3, 3), (2, 2, 2), ((1, 1), (0, 1), (0, 1)), "generic"),
    ((3, 3, 3), (1, 2, 1), ((1, 1), (0, 1), (1, 1)), "generic"),
    ((3, 3, 3), (1, 3, 3), ((1, 1), (1, 1), (1, 1)), "generic"),
    ((3, 5, 5), (1, 1, 1), ((1, 1), (2, 2), (2, 2)), "generic"),
    ((6, 3, 3), (1, 1, 1), ((2, 3), (1, 1), (1, 1)), "generic"),
    ((3, 3, 3), (1, 1, 1), ((1, -1), (1, 1), (1, 1)), "generic"),
])
def test_fwd_body_picks_by_geometry(kdims, strides, pads, want):
    assert depthwise.fwd_body(kdims, strides, pads) == want


def _out_shape(shape, kdims, strides, pads):
    return [depthwise._out_size(n, k, s, p) for n, k, s, p in
            zip(shape[1:4], kdims, strides, pads)]


PLAN_LAYOUTS = [(2, 16), (2, 2), (4, 16), (4, 4), (2, 8)]


@pytest.mark.parametrize("elem,align", PLAN_LAYOUTS)
@pytest.mark.parametrize("name,shape,kdims,strides,pads",
                         MODEL_CONVS + MULTIGRID_CONVS,
                         ids=[c[0] for c in MODEL_CONVS + MULTIGRID_CONVS])
def test_new_body_plans_cover_the_clip(name, shape, kdims, strides, pads,
                                       elem, align):
    """On cards that hold no, 396 and 528 blocks (of 256 threads for the
    temporal body) at once, each output frame lies in exactly one run and
    a run is RING_MIN_RUN frames or more; the temporal body's cells divide
    C and both addresses, and its threads cover every cell; the ring body's
    tiles cover the output plane, every channel group starts on a copy
    granule, one tile row a thread, and the block fits its threads and
    shared memory."""
    B, T, H, W, C = shape
    To, Ho, Wo = _out_shape(shape, kdims, strides, pads)
    for slots in (0, 396, 528):
        if name.endswith("stem"):
            p = depthwise.temporal_plan(B, Ho, Wo, C, To, elem, align,
                                        slots * depthwise.TEMPORAL_THREADS)
            assert C % p["vec"] == 0 and p["cell_bytes"] <= 16
            assert align % p["cell_bytes"] == 0
            assert p["cell_bytes"] == p["vec"] * elem
            if align == 16 and elem == 2:
                assert p["vec"] == 8                 # C 24 and 32: 16 bytes
            cells = B * Ho * Wo * C // p["vec"]
            assert p["blocks"] * p["threads"] >= cells
            assert (p["blocks"] - 1) * p["threads"] < cells
            if p["runs"] > 1:
                assert cells * (p["runs"] - 1) < 2 * slots * p["threads"]
        else:
            p = depthwise.ring_plan(B, To, Ho, Wo, C, kdims[0], strides[1],
                                    elem, align, slots)
            for n, side, tiles in ((Ho, p["tile_h"], p["tiles_h"]),
                                   (Wo, p["tile_w"], p["tiles_w"])):
                assert side == n if n <= ring.RING_MAX_SIDE_2 else \
                    ring.RING_MAX_SIDE_2 // 2 <= side <= ring.RING_MAX_SIDE_2
                assert (tiles - 1) * side < n <= tiles * side
            vec, g = p["vec"], p["granule"]
            assert vec == 2 and p["group"] % vec == 0
            assert g == (vec * elem if align % (vec * elem) == 0 else elem)
            starts = [i * p["group"] for i in range(p["groups"])]
            assert all(c * elem % g == 0 for c in starts)
            assert starts[-1] < C <= starts[-1] + p["group"]
            assert p["rows"] == p["tile_h"]            # a tile row a thread
            block = p["group"] // vec * p["rows"]
            assert block <= ring.RING_MAX_THREADS
            assert p["threads"] == -(-block // 32) * 32
            assert p["smem_bytes"] <= depthwise.CONV_RING_SMEM
            slot = p["group"] // vec * (
                ring.ring_rows(p["tile_h"], 2) * p["row_cells"]
                + p["vec_pad"]) * vec * elem
            assert p["smem_bytes"] >= (kdims[0] + ring.RING_AHEAD) * slot
            assert 0 <= p["vec_pad"] < 32
            assert 0 <= p["row_cells"] - ring.ring_cols(p["tile_w"], 2) < 8
            blocks = p["groups"] * p["tiles_h"] * p["tiles_w"] * B
            if p["runs"] > 1:
                assert blocks * (p["runs"] - 1) < 2 * slots
        frames = [t for i in range(p["runs"])
                  for t in range(i * p["run"], min((i + 1) * p["run"], To))]
        assert frames == list(range(To))
        assert p["runs"] == 1 or p["run"] >= ring.RING_MIN_RUN


def _by_ring_staging(x, k, strides, pads):
    """y of the ring body rebuilt in numpy from its staging map: for each
    tile of the plan and each input frame, the staged rows and cells as the
    kernel lays them out (input columns in order), zero outside the image;
    each output pixel, in runs of four then pairs along its row, sums the
    cells the kernel's tap rule names (cell s * ow + j feeds tap j - s * k
    of pixel k)."""
    B, T, H, W, C = x.shape
    kt = k.shape[0]
    s = strides[1]
    (tlo, _), (hlo, _), (wlo, _) = pads
    To, Ho, Wo = _out_shape(x.shape, k.shape[:3], strides, pads)
    p = depthwise.ring_plan(B, To, Ho, Wo, C, kt, s, 4, 16, 0)
    TH, TW, WP = p["tile_h"], p["tile_w"], p["row_cells"]
    y = np.full((B, To, Ho, Wo, C), np.nan, np.float32)
    for h0 in range(0, Ho, TH):
        for w0 in range(0, Wo, TW):
            hi0, wi0 = h0 * s - hlo, w0 * s - wlo
            staged = np.zeros((T, ring.ring_rows(TH, s), WP, B, C),
                              np.float32)
            for pr in range(staged.shape[1]):
                for pc in range(WP):
                    hi, wi = hi0 + pr, wi0 + pc
                    if 0 <= hi < H and 0 <= wi < W:
                        staged[:, pr, pc] = x[:, :, hi, wi].transpose(1, 0, 2)
            cols = min(TW, Wo - w0)
            for t in range(To):
                for oh in range(min(TH, Ho - h0)):
                    ow = 0
                    while ow < cols:
                        n = 4 if ow + 4 <= cols else 2
                        acc = np.zeros((n, B, C), np.float32)
                        for dt in range(kt):
                            tp = t - tlo + dt
                            if not 0 <= tp < T:
                                continue
                            for dh in range(3):
                                row = staged[tp, s * oh + dh, s * ow:]
                                assert len(row) >= s * (n - 1) + 3
                                for j in range(s * (n - 1) + 3):
                                    for kk in range(n):
                                        if 0 <= j - s * kk < 3:
                                            acc[kk] += row[j] * \
                                                k[dt, dh, j - s * kk, 0]
                        for kk in range(min(n, cols - ow)):
                            y[:, t, h0 + oh, w0 + ow + kk] = acc[kk]
                        ow += n
    return y


@pytest.mark.parametrize("shape,kdims,strides,padding", [
    ((2, 4, 9, 11, 3), (3, 3, 3), (1, 2, 2), "SAME"),       # odd: (1, 1)
    ((2, 4, 8, 10, 3), (3, 3, 3), (1, 2, 2), "SAME"),       # even: (0, 1)
    ((1, 3, 20, 17, 2), (5, 3, 3), (1, 2, 2), "SAME"),      # two tiles
    ((1, 3, 7, 9, 2), (1, 3, 3), (1, 2, 2), ((0, 0), (0, 2), (1, 0))),
    ((2, 4, 9, 11, 3), (3, 3, 3), (1, 1, 1), "SAME"),
    ((1, 3, 16, 17, 2), (3, 3, 3), (1, 1, 1), ((0, 2), (0, 0), (1, 1))),
])
def test_ring_staging_map_rebuilds_the_conv(shape, kdims, strides, padding):
    x, k = _inputs(5, shape, kdims)
    pads = depthwise._resolve_pads(shape, kdims, strides, padding)
    assert depthwise.fwd_body(kdims, strides, pads) == "ring"
    want = depthwise.depthwise_conv3d_reference(
        torch.from_numpy(x), torch.from_numpy(k), strides, pads).numpy()
    np.testing.assert_allclose(_by_ring_staging(x, k, strides, pads), want,
                               rtol=1e-5, atol=1e-5)


class _FailingLibrary:
    """A K1 library whose new bodies fail at launch; it records the
    calls."""

    def __init__(self):
        self.calls = []

    def _occupancy(self, body, out):
        self.calls.append(f"{body} occupancy")
        ctypes.cast(out, ctypes.POINTER(ctypes.c_int * 2)).contents[:] = \
            [3, 132]
        return 0

    def x3d_dw_conv3d_fwd_temporal_occupancy(self, *args):
        return self._occupancy("temporal", args[-1])

    def x3d_dw_conv3d_fwd_ring_occupancy(self, *args):
        return self._occupancy("ring", args[-1])

    def x3d_dw_conv3d_fwd_temporal(self, *args):
        self.calls.append("temporal")
        return 1                                   # cudaErrorInvalidValue

    def x3d_dw_conv3d_fwd_ring(self, *args):
        self.calls.append("ring")
        return 1

    def __getattr__(self, name):                   # the generic body's
        raise AssertionError(f"fell back to {name}")


@pytest.mark.parametrize("body,shape,kdims,strides,pads", [
    ("temporal", (2, 5, 3, 3, 8), (5, 1, 1), (1, 1, 1),
     ((2, 2), (0, 0), (0, 0))),
    ("ring", (2, 5, 6, 6, 8), (3, 3, 3), (1, 2, 2),
     ((1, 1), (0, 1), (0, 1)))])
def test_failed_new_body_launch_raises_without_fallback(body, shape, kdims,
                                                        strides, pads):
    """A launch of either new body that returns an error raises; the
    generic body is never asked to take over."""
    x, k = (torch.from_numpy(a) for a in _inputs(9, shape, kdims))
    assert depthwise.fwd_body(kdims, strides, pads) == body
    lib = _FailingLibrary()
    ring._slots.clear()
    with pytest.raises(RuntimeError, match=rf"{body} body.*CUDA error 1"):
        depthwise._launch_fwd(lib, body, x, k.reshape(-1, 8).contiguous(),
                              kdims, strides, pads, 0)
    ring._slots.clear()
    assert lib.calls == [f"{body} occupancy", body]


# ------------------------------------------------------------ on the card

CARD_CONVS = [(shape, kdims, strides, pads)
              for v in ("M", "S") for _, shape, kdims, strides, pads in
              _model_convs(v, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kdims,strides,padding", SAME_CASES + [
    ((3, 5, 9, 11, 70), (3, 3, 3), (1, 2, 2), "SAME"),
    ((2, 5, 9, 11, 70), (3, 3, 3), (1, 1, 1), "SAME"),
    ((2, 4, 6, 6, 24), (5, 1, 1), (1, 1, 1), ((2, 2), (0, 0), (0, 0))),
    ((2, 5, 9, 11, 7), (5, 3, 3), (1, 2, 2), "SAME"),
    ((2, 5, 9, 11, 6), (3, 5, 5), (1, 1, 1), "SAME"),
    ((2, 6, 9, 11, 6), (3, 3, 3), (2, 2, 2), "SAME")] + CARD_CONVS)
def test_kernel_matches_plain_on_card(cuda, dtype, shape, kdims, strides,
                                      padding):
    """float32: atol 1e-4; bfloat16 against the plain version in float32 on
    the same bfloat16 inputs: 2e-2 of the largest |reference|.  Every stem
    and stage-entry shape of X3D-M and X3D-S at 2 clips (the stem the
    temporal body, the entries the ring body), X3D-XS's stem (4 frames, 5
    taps) and the generic body's geometries; the counters say which body
    each call took."""
    x, k = (torch.from_numpy(a).to(cuda) for a in _inputs(3, shape, kdims))
    x, k = x.to(dtype), k.to(dtype)
    pads = depthwise._resolve_pads(shape, kdims, strides, padding)
    body = depthwise.fwd_body(kdims, strides, pads)
    if (shape, kdims, strides, padding) in CARD_CONVS:
        assert body == ("temporal" if kdims[1:] == (1, 1) else "ring")
    fn = depthwise.depthwise_conv3d
    before = (fn.launches, dict(fn.body_launches))
    got = fn(x, k, strides, padding)
    torch.cuda.synchronize()
    assert fn.launches == before[0] + 1
    assert fn.body_launches == before[1] | {body: before[1][body] + 1}
    assert got.dtype == dtype
    want = depthwise.depthwise_conv3d_reference(x.float(), k.float(),
                                                strides, pads)
    err = (got.float() - want).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-4
    else:
        assert err <= 2e-2 * want.abs().max().item()


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
@pytest.mark.parametrize("shape,kdims,strides,pads", [
    ((2, 5, 12, 12, 24), (5, 1, 1), (1, 1, 1), ((2, 2), (0, 0), (0, 0))),
    ((2, 5, 28, 28, 54), (3, 3, 3), (1, 2, 2), ((1, 1), (0, 1), (0, 1))),
    ((2, 5, 13, 13, 216), (3, 3, 3), (1, 2, 2), ((1, 1), (1, 1), (1, 1)))],
    ids=["temporal", "ring-even", "ring-odd"])
def test_new_bodies_take_unaligned_inputs(cuda, dtype, offset, shape, kdims,
                                          strides, pads):
    """x starting 2 to 16 bytes into its allocation: the temporal body's
    cells and the ring body's copy granule shrink to what the address
    allows; results as above."""
    x, k = (torch.from_numpy(a).to(cuda) for a in _inputs(6, shape, kdims))
    x, k = _on_card_at(x.to(dtype), offset), k.to(dtype)
    assert x.data_ptr() % 32 == offset % 32
    fn = depthwise.depthwise_conv3d
    body = depthwise.fwd_body(kdims, strides, pads)
    before = dict(fn.body_launches)
    got = fn(x, k, strides, pads)
    torch.cuda.synchronize()
    assert fn.body_launches == before | {body: before[body] + 1}
    want = depthwise.depthwise_conv3d_reference(x.float(), k.float(),
                                                strides, pads)
    err = (got.float() - want).abs().max().item()
    tol = 1e-4 if dtype == torch.float32 else 2e-2 * want.abs().max().item()
    assert err <= tol


FULL_CONVS = [(f"{v}-B{B}-{name}", shape, kdims, strides, pads)
              for v, batches in (("M", (10, 80, 32)), ("S", (80, 64)))
              for B in batches
              for name, shape, kdims, strides, pads in _model_convs(v, B)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,kdims,strides,pads", FULL_CONVS,
                         ids=[c[0] for c in FULL_CONVS])
def test_new_bodies_repeat_bit_for_bit(cuda, name, shape, kdims, strides,
                                       pads):
    """No atomics and a fixed order of sums: bfloat16 calls on one input
    give equal bits, at the full serving, eval and training batches of
    X3D-M and X3D-S."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(shape, generator=gen, device=cuda).bfloat16()
    k = (0.3 * torch.randn((*kdims, 1, shape[-1]), generator=gen,
                           device=cuda)).bfloat16()
    first = depthwise.depthwise_conv3d(x, k, strides, pads)
    second = depthwise.depthwise_conv3d(x, k, strides, pads)
    assert torch.equal(first, second)


# ------------------------------------------------------ the BN epilogue


@pytest.mark.parametrize("shape,kdims,strides,padding,relu", [
    ((2, 6, 5, 5, 8), (5, 1, 1), (1, 1, 1), ((2, 2), (0, 0), (0, 0)), True),
    ((2, 4, 7, 7, 8), (3, 3, 3), (1, 2, 2), "SAME", False)],
    ids=["temporal_bn_relu", "ring_bn"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_epilogue_plain_equals_the_unfused_sequence(dtype, shape, kdims,
                                                    strides, padding, relu):
    """K1 temporal + bn + ReLU (the stem) and K1 ring + bn (bn_b at the
    stage entries) on the CPU: the wrapper, its op and the differentiable
    entry with autograd off (the kernel's route and ``plain_versions()``)
    give the plain conv then the model's affine (then the ReLU), bit for
    bit; the launch log names the epilogue and counts its work."""
    x, k = (torch.from_numpy(a) for a in _inputs(51, shape, kdims))
    x, k = x.to(dtype), k.to(dtype)
    mul, add = bn_coefs(52, 8)
    pads = depthwise._resolve_pads(shape, kdims, strides, padding)
    want = unfused(depthwise.depthwise_conv3d(x, k, strides, pads), mul, add,
                   relu)
    with torch.no_grad(), ops.launch_log() as log:
        calls = [depthwise.depthwise_conv3d(x, k, strides, pads, mul, add,
                                            relu),
                 library.depthwise_conv3d(x, k, list(strides),
                                          [v for p in pads for v in p], mul,
                                          add, relu),
                 depthwise.depthwise(x, k, strides, pads, mul, add, relu)]
        with plain_versions():
            calls.append(depthwise.depthwise(x, k, strides, pads, mul, add,
                                             relu))
    for got in calls:
        assert got.dtype == dtype and torch.equal(got, want)
    kind = "bn_relu" if relu else "bn"
    assert [r["epilogue"] for r in log] == [kind] * 3
    work = depthwise.fwd_cost(shape, want.shape, kdims, x.element_size())
    assert (log[0]["bytes"], log[0]["flops"]) == \
        (work[0] + 8 * 8, work[1] + (3 if relu else 2) * want.numel())


@pytest.mark.parametrize("relu", [False, True], ids=["bn", "bn_relu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_epilogue_op_passes_opcheck(dtype, relu):
    """``x3d::depthwise_conv3d`` with the epilogue's arguments, strided:
    its schema, and its fake's output against the real one's shape, dtype
    and strides (``torch.library.opcheck``)."""
    x, k = (torch.from_numpy(a).to(dtype)
            for a in _inputs(53, (2, 5, 7, 9, 8), (3, 3, 3)))
    mul, add = bn_coefs(54, 8)
    torch.library.opcheck(library.depthwise_conv3d,
                          (x, k, [1, 2, 2], [1, 1, 0, 1, 1, 1], mul, add,
                           relu),
                          test_utils=("test_schema", "test_faketensor"))


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True], ids=["bn", "bn_relu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kdims,strides,padding", [
    ((2, 16, 12, 12, 24), (5, 1, 1), (1, 1, 1), ((2, 2), (0, 0), (0, 0))),
    ((2, 6, 5, 5, 7), (5, 1, 1), (1, 1, 1), ((2, 2), (0, 0), (0, 0))),
    ((2, 16, 28, 28, 108), (3, 3, 3), (1, 2, 2), "SAME"),
    ((3, 5, 9, 11, 70), (3, 3, 3), (1, 1, 1), "SAME"),
    ((2, 5, 9, 11, 6), (3, 5, 5), (1, 1, 1), "SAME")])
def test_epilogue_matches_the_unfused_launch_on_card(cuda, dtype, shape,
                                                     kdims, strides, padding,
                                                     relu):
    """Each body's epilogue (temporal at 1x1 spatial taps, at even and odd
    C; ring at 3x3, strides 2 and 1; generic at 3x5x5): y equals the same
    body's launch without one followed by the plain epilogue
    (``torch.addcmul``, as the model's affine), bit for bit; the wrapper
    counts the launch under its kind."""
    x, k = (torch.from_numpy(a).to(cuda) for a in _inputs(55, shape, kdims))
    x, k = x.to(dtype), k.to(dtype)
    C = shape[-1]
    mul, add = (v.to(cuda) for v in bn_coefs(56, C))
    pads = depthwise._resolve_pads(shape, kdims, strides, padding)
    body = depthwise.fwd_body(kdims, strides, pads)
    taps = k.float().reshape(-1, C).contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    libs = [epilogue.library("depthwise.cu", depthwise._SIGNATURES, coefs)
            for coefs in (None, (mul, add))]
    y0 = depthwise._launch_fwd(libs[0], body, x, taps, kdims, strides, pads,
                               stream)
    y1 = depthwise._launch_fwd(libs[1], body, x, taps, kdims, strides, pads,
                               stream, epilogue.pointers((mul, add), relu))
    kind = "bn_relu" if relu else "bn"
    fn = depthwise.depthwise_conv3d
    before = dict(fn.epilogue_launches)
    y2 = fn(x, k, strides, pads, mul, add, relu)
    torch.cuda.synchronize()
    assert fn.epilogue_launches == before | {kind: before[kind] + 1}
    want = epilogue.reference(y0, mul, add, relu)
    assert torch.equal(y1, want) and torch.equal(y2, want)
