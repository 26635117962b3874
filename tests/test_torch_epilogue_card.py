"""Serving's BatchNorms as the epilogues of K7, K2 and K1, on the card.

* Every fused call of an X3D-M eval forward at the serving cell's batch
  (8 videos × 10 views, bfloat16; float32 at one video) equals the same
  kernel's launch without the epilogue followed by its plain version
  (``torch.addcmul``, the model's affine, then the ReLU), bit for bit, and
  K2's sums equal that launch's; the forward makes 62 such calls.
* ``InferenceEngine.predict`` on 8 X3D-M videos gives the answers of the
  unfused path (the model in eval mode with autograd on, every BatchNorm
  by the model's affine) bit for bit.
* The launches without an epilogue (training's) run the libraries built
  without it, which refuse a launch with one; the epilogue's libraries
  (built with ``_build.BN_EPILOGUE``) refuse a launch without one.

Every test here needs a CUDA card (marker ``cuda``) and none imports JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_epilogue_card.py``.
"""

import collections
import functools
import inspect

import numpy as np
import pytest
import torch

from x3d_tpu_torch import utils, variant_config
from x3d_tpu_torch.models import create_model, x3d
from x3d_tpu_torch.ops import depthwise, dw_fused, epilogue, pointwise
from x3d_tpu_torch.serving import InferenceEngine, serve_forward

# the wrappers of the kernels that take an epilogue, by the modules that
# call them by name
WRAPPERS = {"K1": (depthwise, "depthwise_conv3d"),
            "K2": (dw_fused, "dw_bn_act_conv"),
            "K7": (pointwise, "pw_conv")}
# their launch functions and sources: (module, name, source)
LAUNCHES = {"K1": (depthwise, "_launch_fwd", "depthwise.cu"),
            "K2": (dw_fused, "_launch_fwd", "dw_fused.cu"),
            "K7": (pointwise, "_launch", "pointwise.cu")}
# an X3D eval forward's BatchNorms that ride a kernel: K7 bn_c (26), bn_r
# (4), bn_a + ReLU at the stage entries (4), bn_5 + ReLU; K2 bn_b (22); K1
# bn_b at the stage entries (4), the stem's BN + ReLU
EPILOGUES = {("K7", "bn"): 30, ("K7", "bn_relu"): 5, ("K2", "bn"): 22,
             ("K1", "bn"): 4, ("K1", "bn_relu"): 1}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    utils.use_deterministic_cudnn()
    return torch.device("cuda")


def random_bn(model, seed):
    """BatchNorm variables off their initial values: scales 0.5 to 1.5,
    offsets of both signs, running means of both signs, variances 0.5 to
    1.5."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, x3d.BatchNorm):
                n, c = bn.norm, bn.norm.scale.shape[0]
                n.scale.copy_(0.5 + torch.rand(c, generator=g))
                n.bias.copy_(0.3 * torch.randn(c, generator=g))
                n.mean.copy_(0.2 * torch.randn(c, generator=g))
                n.var.copy_(0.5 + torch.rand(c, generator=g))


def _model(cuda, dtype, seed):
    cfg = variant_config("M")
    model = create_model(cfg, dtype=dtype, device=cuda, seed=seed)
    random_bn(model, seed + 1)
    return cfg, model


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,videos", [(torch.bfloat16, 8),
                                          (torch.float32, 1)],
                         ids=["bfloat16-8videos", "float32-1video"])
def test_every_fused_call_equals_its_unfused_launch(cuda, monkeypatch, dtype,
                                                    videos):
    """X3D-M at 16×224², 10 views a video: each of the forward's 62 calls
    with an epilogue (every eval shape, every body it takes) gives the
    unfused launch's output through the plain epilogue, bit for bit."""
    cfg, model = _model(cuda, dtype, 11)
    seen, wrong = collections.Counter(), []
    for kernel, (module, name) in WRAPPERS.items():
        fn = getattr(module, name)
        sig = inspect.signature(fn)

        @functools.wraps(fn)          # its counters, which it increments
        def checked(*args, _k=kernel, _fn=fn, _sig=sig, **kwargs):
            bound = _sig.bind(*args, **kwargs)
            bound.apply_defaults()
            a = bound.arguments
            got = _fn(*args, **kwargs)
            if a["mul"] is None:
                return got
            kind = "bn_relu" if a["relu"] else "bn"
            seen[_k, kind] += 1
            plain = _fn(**(a | {"mul": None, "add": None, "relu": False}))
            outs = (got, plain) if _k != "K2" else (got[0], plain[0])
            want = epilogue.reference(outs[1], a["mul"], a["add"], a["relu"])
            same = torch.equal(outs[0], want)
            if _k == "K2":
                same = same and torch.equal(got[1], plain[1]) \
                    and torch.equal(got[2], plain[2])
            if not same:
                wrong.append((_k, kind, tuple(outs[0].shape)))
            return got

        monkeypatch.setattr(module, name, checked)
    views = cfg.TEST.NUM_TEMPORAL_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    x = torch.randn((videos * views, cfg.DATA.TEMP_DURATION,
                     cfg.DATA.TEST_CROP_SIZE, cfg.DATA.TEST_CROP_SIZE, 3),
                    generator=torch.Generator(device=cuda).manual_seed(12),
                    device=cuda).to(dtype)
    with torch.inference_mode():
        model(x)
    torch.cuda.synchronize()
    assert dict(seen) == EPILOGUES
    assert wrong == []


@pytest.mark.cuda
def test_engine_answers_equal_the_unfused_path(cuda, monkeypatch):
    """``InferenceEngine.predict`` on 8 X3D-M videos (uint8, bfloat16
    compute) against ``serve_forward`` on the same model with autograd on
    and no parameter needing a gradient (so nothing is recorded): the
    unfused path, the model's affine at every BatchNorm.  Equal bits."""
    cfg, model = _model(cuda, torch.bfloat16, 21)
    engine = InferenceEngine(cfg, model, max_videos=8)
    clips = np.random.default_rng(22).integers(
        0, 256, engine.clip_shape, dtype=np.uint8)
    got = engine.predict(clips)
    for p in model.parameters():
        p.requires_grad_(False)
    calls = collections.Counter()
    affine = x3d.affine

    def counted(*args, **kwargs):
        calls["affine"] += 1
        return affine(*args, **kwargs)

    monkeypatch.setattr(x3d, "affine", counted)
    with torch.enable_grad():
        want = serve_forward(model, torch.from_numpy(clips).to(cuda),
                             cfg.DATA.MEAN, cfg.DATA.STD)
    assert calls["affine"] == 62
    want = want.to(torch.float32).cpu().numpy()
    assert got.shape == want.shape == (8, cfg.NETWORK.NUM_CLASSES)
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K2", "K7"])
def test_each_library_refuses_the_other_launches(cuda, kernel):
    """A kernel's library as training loads it holds no body with the BN
    epilogue, so that training's launches run the code they ran before
    there was one: asked for an epilogue, its launch fails; the
    epilogue's library, built from the same source, fails a launch
    without one.  The rule of the C interface's ``with_epilogue``."""
    module, _, source = LAUNCHES[kernel]
    x = torch.randn((2, 4, 8, 8, 8), device=cuda).bfloat16()
    mul = torch.ones(8, device=cuda)
    bn = epilogue.pointers((mul, torch.zeros_like(mul)), False)
    stream = torch.cuda.current_stream().cuda_stream
    for coefs, wrong in ((None, bn), ((mul, mul), epilogue.NO_POINTERS)):
        lib = epilogue.library(source, module._SIGNATURES, coefs)
        if kernel == "K7":
            w = torch.randn((8, 8), device=cuda).bfloat16()
            call = lambda: pointwise._launch(  # noqa: E731
                lib, "wg", x, w, (1, 1, 1), stream, bn=wrong)
        elif kernel == "K2":
            cols = torch.ones((8, 2), device=cuda)
            taps = torch.randn((27, 8), device=cuda)
            call = lambda: dw_fused._launch_fwd(  # noqa: E731
                lib, "ring", x, cols, cols, taps, (3, 3, 3), stream, wrong)
        else:
            taps = torch.randn((27, 8), device=cuda)
            call = lambda: depthwise._launch_fwd(  # noqa: E731
                lib, "ring", x, taps, (3, 3, 3), (1, 2, 2),
                ((1, 1), (0, 1), (0, 1)), stream, wrong)
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            call()
