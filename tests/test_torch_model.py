"""The port's eval-mode X3D against the JAX model, on converted weights.

Tiny config (8-wide stem, six blocks, 2 views, T=5, 32² crop), float32 on
the CPU; the ``_scale_res2`` cases take X3D-XL's branch of the plan
(``SCALE_RES2: True``, ``WIDTH_FACTOR: 2.9``: a 16-wide stem, stages 16,
24, 48 and 96 wide).  The JAX model runs once with the fused segment off
(the unfused composition) and once with the Pallas segment kernel in
interpret mode; the
port runs its fused structure through the kernels' plain versions.  BN
scales, offsets and running statistics are random and non-trivial, with
offsets of both signs so that a border bug in the fused ReLU would show.

Tolerances (float32, sums in another order): logits rtol 1e-4 / atol 1e-5,
view-averaged probabilities atol 1e-6.

In eval mode with autograd off every BatchNorm rides the kernel launch
that writes its input as its epilogue: the launch log of one eval forward
names 62 of them and the model's affine is never called, and the answers
equal those of the unfused path (eval with autograd on) bit for bit; a
training step passes none.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_epilogue_card import EPILOGUES, random_bn
from x3d_tpu import get_default_config as jax_default_config
from x3d_tpu.models import create_model as jax_create_model
from x3d_tpu.models import init_variables
from x3d_tpu.ops import dw_fused as jax_dw_fused
from x3d_tpu_torch import convert, get_default_config, ops, variant_config
from x3d_tpu_torch.data import synthetic_batches
from x3d_tpu_torch.models import build_arch, create_model, x3d
from x3d_tpu_torch.train import create_train_state, make_train_step

VIEWS, VIDEOS, T, S, CLASSES = 2, 2, 5, 32, 11


def _tiny(cfg, scale_res2=False):
    if scale_res2:
        cfg.NETWORK.SCALE_RES2 = True
        cfg.NETWORK.WIDTH_FACTOR = 2.9
    cfg.NETWORK.C1_CHANNELS = 4
    cfg.NETWORK.DEPTH_FACTOR = 0.34
    cfg.NETWORK.NUM_CLASSES = CLASSES
    cfg.DATA.TEMP_DURATION = T
    cfg.DATA.TEST_CROP_SIZE = S
    cfg.TEST.NUM_TEMPORAL_VIEWS = VIEWS
    cfg.TEST.NUM_SPATIAL_CROPS = 1
    return cfg


def randomize_bn(tree, rng):
    """Non-trivial BN variables: scale in [0.5, 1.5], offsets and means of
    both signs, variances in [0.5, 1.5]."""
    def walk(p, s):
        for k in list(p):
            if k == "norm":
                c = p[k]["scale"].shape
                p[k] = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                        "bias": rng.normal(0, 0.3, c).astype(np.float32)}
                s[k] = {"mean": rng.normal(0, 0.2, c).astype(np.float32),
                        "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
            elif isinstance(p[k], dict):
                walk(p[k], s.setdefault(k, {}))
    params, stats = _thaw(tree["params"]), _thaw(tree["batch_stats"])
    walk(params, stats)
    return {"params": params, "batch_stats": stats}


def _thaw(tree):
    return {k: _thaw(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


def _setup(scale_res2):
    torch.set_num_threads(1)
    cfg = _tiny(jax_default_config(), scale_res2)
    model = jax_create_model(cfg, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(VIDEOS * VIEWS, T, S, S, 3)).astype(np.float32)
    old = jax_dw_fused.get_enabled()
    jax_dw_fused.set_enabled(False)
    try:
        variables = init_variables(model, jax.random.PRNGKey(0),
                                   jnp.asarray(x))
    finally:
        jax_dw_fused.set_enabled(old)
    variables = randomize_bn(variables, rng)
    port = create_model(_tiny(get_default_config(), scale_res2),
                        dtype=torch.float32, device="cpu", init=False)
    port.load_state_dict(convert.flax_to_state_dict(variables))
    with torch.inference_mode():
        xt = torch.from_numpy(x)
        got = (port(xt, return_logits=True).numpy(), port(xt).numpy())
    return dict(model=model, variables=variables, x=x, got=got, port=port)


@pytest.fixture(scope="module")
def setup():
    return _setup(False)


@pytest.fixture(scope="module")
def setup_scale_res2():
    return _setup(True)


def _jax_forward(setup, mode):
    model, variables, x = setup["model"], setup["variables"], setup["x"]
    old_i, old_e = jax_dw_fused.INTERPRET, jax_dw_fused.get_enabled()
    jax_dw_fused.INTERPRET = True
    jax_dw_fused.set_enabled(mode)
    try:
        logits = jax.jit(lambda v, x_: model.apply(
            v, x_, train=False, return_logits=True))(variables, x)
    finally:
        jax_dw_fused.INTERPRET = old_i
        jax_dw_fused.set_enabled(old_e)
    # the JAX head's softmax and view average (x3d_tpu/models/x3d.py:870-874)
    # on its own logits: one trace of the interpreted kernels, not two
    probs = jax.nn.softmax(logits, axis=-1).reshape(-1, VIEWS, CLASSES)
    return np.asarray(logits), np.asarray(probs.mean(axis=1))


def _assert_eval(setup, mode):
    want_logits, want_probs = _jax_forward(setup, mode)
    got_logits, got_probs = setup["got"]
    assert got_probs.shape == (VIDEOS, CLASSES)
    np.testing.assert_allclose(got_logits, want_logits, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_probs, want_probs, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", [False, "pallas"],
                         ids=["jax_unfused", "jax_pallas_segment"])
def test_eval_matches_jax(setup, mode):
    _assert_eval(setup, mode)


@pytest.mark.parametrize("mode", [False], ids=["jax_unfused"])
def test_eval_matches_jax_scale_res2(setup_scale_res2, mode):
    arch = setup_scale_res2["port"].arch
    assert arch.conv1_dim == 16
    assert [b[0].out_channels for b in arch.stages] == [16, 24, 48, 96]
    _assert_eval(setup_scale_res2, mode)


def test_training_mode_raises(setup):
    """Training mode runs (batch statistics, see test_torch_train.py); with
    dropout it needs an explicit generator for the mask and raises
    without one."""
    cfg = _tiny(get_default_config())
    cfg.NETWORK.DROPOUT_RATE = 0.5
    port = create_model(cfg, dtype=torch.float32, device="cpu", init=False)
    port.load_state_dict(setup["port"].state_dict())
    port.train()
    x = torch.from_numpy(setup["x"])
    with pytest.raises(ValueError, match="Generator"):
        port(x)
    logits = port(x, return_logits=True, generator=torch.Generator())
    assert logits.shape == (VIDEOS * VIEWS, CLASSES)
    assert torch.isfinite(logits).all()


def test_create_model_needs_a_device_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model(_tiny(get_default_config()))


# ------------------------------------------- BatchNorm as kernel epilogues

@pytest.mark.parametrize("variant,dtype", [("XS", torch.float32),
                                           ("M", torch.bfloat16)],
                         ids=["XS-float32", "M-bfloat16"])
def test_eval_forward_folds_every_batchnorm_into_its_kernel(
        monkeypatch, variant, dtype):
    """X3D-XS (4 frames) and X3D-M (16 frames) at 32², one clip, on the
    CPU: with autograd off the launch log holds 62 epilogues (K7 35, 5 of
    them with the ReLU; K2 22; K1 5, 1 with the ReLU) and the model's
    affine is called 0 times; the logits equal those of the unfused path
    (eval with autograd on: the model's affine 62 times) bit for bit."""
    torch.set_num_threads(1)
    cfg = variant_config(variant)
    cfg.merge_from_list(["DATA.TEST_CROP_SIZE", 32,
                         "TEST.NUM_TEMPORAL_VIEWS", 1,
                         "TEST.NUM_SPATIAL_CROPS", 1])
    model = create_model(cfg, dtype=dtype, device="cpu", seed=5)
    random_bn(model, 6)
    x = torch.randn((1, cfg.DATA.TEMP_DURATION, 32, 32, 3),
                    generator=torch.Generator().manual_seed(7))
    calls = collections.Counter()
    affine = x3d.affine

    def counted(*args, **kwargs):
        calls[torch.is_grad_enabled()] += 1
        return affine(*args, **kwargs)

    monkeypatch.setattr(x3d, "affine", counted)
    with torch.no_grad(), ops.launch_log() as log:
        fused = model(x, return_logits=True)
    unfused = model(x, return_logits=True)
    got = collections.Counter((r["kernel"], r["epilogue"]) for r in log
                              if r["epilogue"] != "none")
    assert dict(got) == EPILOGUES
    assert calls == {True: 62}
    assert torch.equal(fused, unfused.detach())


def test_training_step_passes_no_epilogue():
    """A training step (tiny X3D-S, float32, on the CPU) logs no epilogue
    and the launches the step's plan gives (``chip_smoke.want_step_of``)."""
    torch.set_num_threads(1)
    cfg = variant_config("S")
    cfg.merge_from_list(["NETWORK.C1_CHANNELS", 4,
                         "NETWORK.DEPTH_FACTOR", 0.34,
                         "DATA.TEMP_DURATION", 6, "DATA.TRAIN_CROP_SIZE", 32])
    model = create_model(cfg, dtype=torch.float32, device="cpu")
    state = create_train_state(cfg, model)
    batch = next(synthetic_batches(cfg, 2, dtype=torch.float32,
                                   device="cpu"))
    with ops.launch_log() as log:
        make_train_step(model, cfg.NETWORK.WEIGHT_DECAY)(
            state, batch, torch.Generator().manual_seed(0))
    assert {r["epilogue"] for r in log} == {"none"}
    want = chip_smoke.want_step_of(build_arch(cfg), True, "off")
    assert dict(collections.Counter(r["kernel"] for r in log)) == \
        {k: n for k, n in want.items() if n}



@pytest.mark.parametrize("hook", ["conv", "batchnorm", "every module"])
def test_a_forward_hook_sees_the_unfused_output(hook):
    """Tiny X3D-S in eval mode with autograd off, on the CPU: with a
    forward hook on the first block's conv ``c`` (a feature extractor's),
    on its BatchNorm, or on every module (``register_module_forward_hook``)
    that BatchNorm runs as a module of its own and takes no epilogue -- a
    hook on the conv gets the conv's output, before the BatchNorm; one on
    every module leaves no BatchNorm folded -- and the logits stay those
    of the model without a hook; the hook removed, the BatchNorm folds
    again."""
    torch.set_num_threads(1)
    cfg = variant_config("S")
    cfg.merge_from_list(["NETWORK.C1_CHANNELS", 4,
                         "NETWORK.DEPTH_FACTOR", 0.34,
                         "DATA.TEMP_DURATION", 4, "DATA.TEST_CROP_SIZE", 32])
    model = create_model(cfg, dtype=torch.float32, device="cpu", seed=8)
    random_bn(model, 9)
    block = next(m for m in model.modules() if isinstance(m, x3d.Bottleneck))
    x = torch.randn((1, 4, 32, 32, 3),
                    generator=torch.Generator().manual_seed(10))

    def forward():
        with torch.no_grad(), ops.launch_log() as log:
            logits = model(x, return_logits=True)
        return logits, sum(r["epilogue"] != "none" for r in log)

    want, folded = forward()
    seen = []

    def record(module, args, out):
        if module is block.c or module is block.bn_c:
            seen.append((module, args, out))

    if hook == "conv":
        handle = block.c.register_forward_hook(record)
    elif hook == "batchnorm":
        handle = block.bn_c.register_forward_hook(record)
    else:
        handle = torch.nn.modules.module.register_module_forward_hook(record)
    try:
        got, fused = forward()
    finally:
        handle.remove()
    assert torch.equal(got, want)
    assert fused == (0 if hook == "every module" else folded - 1)
    assert block.bn_c in [m for m, _, _ in seen] or hook == "conv"
    for module, args, out in seen:
        if module is block.c:         # the conv alone, no epilogue
            assert len(args) == 1
            assert torch.equal(out, module.forward(args[0]))
            assert not torch.equal(out, block.bn_c(out))
    assert forward()[1] == folded
