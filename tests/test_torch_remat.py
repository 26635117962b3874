"""Rematerialisation in the port's model against the JAX package's modes.

``TPU.REMAT`` (``x3d_tpu/models/x3d.py:747-757``, ``:797-812``): "block"
(or True) recomputes each ResBlock's forward in the backward pass, "stage"
each stage's, "convs" each ResBlock's but its conv outputs (kept: the
outputs of the ``x3d::`` ops, a selective checkpoint); "auto" is "block"
at ``TRAIN_CROP_SIZE >= 312`` (X3D-L and -XL), off otherwise.  A step with
remat must be the step without it, bit for bit: the same loss, gradients
and updated parameters, and the BN running statistics folded once (the
recompute takes the same batch statistics and skips the update).  Tiny XS
geometry of ``test_torch_train`` (T 4, 32², batch 2; 4 with two BN
groups) with dropout 0.5, whose mask is drawn in the head, outside every
recomputed region; the kernels' plain versions on the CPU (through the
ops under "convs"), float32 and bfloat16.  The "convs" step against JAX's
``create_model(remat="convs")`` step is held to ``test_torch_train``'s
tolerances; two gloo ranks under "convs" are in ``test_torch_parallel``.
"""

import collections
import threading

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import test_torch_train as tt
from x3d_tpu import variant_config as jax_variant_config
from x3d_tpu.models import create_model as jax_create_model
from x3d_tpu_torch import ops, variant_config
from x3d_tpu_torch.data import synthetic_batches
from x3d_tpu_torch.models import create_model
from x3d_tpu_torch.models.x3d import BatchNorm, ResBlock
from x3d_tpu_torch.ops import depthwise, dw_fused, library, pointwise, pw_stats
from x3d_tpu_torch.tools.common import setup_runtime
from x3d_tpu_torch.train import create_train_state, make_train_step

VARIANTS = ("XS", "S", "M", "L", "XL")
# the launch functions of the kernels' forwards, by module
FORWARDS = ((depthwise, "depthwise_conv3d"), (dw_fused, "dw_bn_act_conv"),
            (pointwise, "pw_conv"), (pw_stats, "pw_conv_stats"),
            (pw_stats, "pw_act_conv_stats"))


def _step(remat, dtype, bn_groups=1):
    """One training step of the tiny model from seed 0: (loss, gradients,
    state dict after the step, forward calls of each ResBlock)."""
    torch.set_num_threads(1)
    cfg = tt._tiny(variant_config("XS"), dropout=0.5)
    cfg.TRAIN.BATCH_SIZE = tt.B * bn_groups
    model = create_model(cfg, dtype=dtype, device="cpu", seed=0, remat=remat,
                         bn_groups=bn_groups)
    calls = {}
    for name, m in model.named_modules():
        if isinstance(m, ResBlock):
            m.register_forward_pre_hook(
                lambda *_, n=name: calls.__setitem__(n, calls.get(n, 0) + 1))
    state = create_train_state(cfg, model)
    batch = next(synthetic_batches(cfg, tt.B * bn_groups, seed=1,
                                   device="cpu", dtype=dtype))
    state, metrics = make_train_step(model, cfg.NETWORK.WEIGHT_DECAY)(
        state, batch, torch.Generator().manual_seed(3))
    assert not any(m.recomputing for m in model.modules()
                   if isinstance(m, BatchNorm))
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return metrics["loss"].item(), grads, model.state_dict(), calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("remat", [True, "block", "stage", "convs"])
def test_remat_step_is_the_plain_step_bit_for_bit(remat, dtype):
    loss, grads, after, calls = _step(False, dtype)
    r_loss, r_grads, r_after, r_calls = _step(remat, dtype)
    assert set(calls.values()) == {1}
    # every block's forward ran again in the backward pass
    assert r_calls == {n: 2 for n in calls}
    assert r_loss == loss
    assert all(torch.equal(r_grads[n], g) for n, g in grads.items())
    # parameters updated alike, running statistics folded once
    assert all(torch.equal(r_after[n], v) for n, v in after.items())
    init = create_model(tt._tiny(variant_config("XS")), dtype=dtype,
                        device="cpu", seed=0).state_dict()
    moved = [n for n in after if n.endswith((".mean", ".var"))
             and not torch.equal(after[n], init[n])]
    assert len(moved) == sum(n.endswith((".mean", ".var")) for n in after)


def test_remat_off_in_eval_and_without_gradients():
    cfg = tt._tiny(variant_config("XS"))
    model = create_model(cfg, dtype=torch.float32, device="cpu",
                         remat="block")
    x = next(synthetic_batches(cfg, tt.B, seed=1, device="cpu",
                               dtype=torch.float32))["video"]
    want = create_model(cfg, dtype=torch.float32, device="cpu")(x)
    assert torch.equal(model(x), want)
    model.train()
    with torch.no_grad():
        model(x, generator=torch.Generator())


@pytest.mark.parametrize("variant", VARIANTS)
def test_create_model_resolves_auto_as_jax(variant):
    """"auto" (the YAMLs' TPU.REMAT) is per-block remat at 312² (L, XL)
    and none below, as in ``x3d_tpu/models/x3d.py:894-897``."""
    cfg = variant_config(variant)
    assert cfg.TPU.REMAT == "auto"
    want = jax_create_model(jax_variant_config(variant)).remat
    assert want == (variant in ("L", "XL"))
    got = create_model(cfg, device="meta").remat
    assert got == {True: "block", False: "off"}[want]
    for mode, name in ((False, "off"), (True, "block"), ("stage", "stage")):
        assert create_model(cfg, device="meta", remat=mode).remat == name
        cfg.TPU.REMAT = mode
        assert create_model(cfg, device="meta").remat == name


def test_the_tools_take_remat_from_the_config():
    cfg = tt._tiny(variant_config("XS"))
    cfg.TPU.REMAT = "stage"
    _, model, _ = setup_runtime(cfg, 1, mixed_precision=False, debug=False,
                                device="cpu")
    assert model.remat == "stage"


def test_unknown_remat_mode_raises():
    cfg = variant_config("XS")
    with pytest.raises(ValueError, match="remat mode 'layer'"):
        create_model(cfg, device="meta", remat="layer")
    # the JAX package refuses the same mode when the model is traced
    model = jax_create_model(tt._tiny(jax_variant_config("XS")),
                             remat="layer")
    x = jnp.zeros((1, tt.T, tt.S, tt.S, 3))
    with pytest.raises(ValueError, match="remat mode 'layer'"):
        jax.eval_shape(model.init, jax.random.PRNGKey(0), x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_convs_step_with_two_bn_groups_is_the_plain_step(dtype):
    """Grouped statistics (per-sample coefficient columns into the kernels)
    under "convs", bit for bit the step without remat."""
    loss, grads, after, _ = _step(False, dtype, bn_groups=2)
    r_loss, r_grads, r_after, _ = _step("convs", dtype, bn_groups=2)
    assert r_loss == loss
    assert all(torch.equal(r_grads[n], g) for n, g in grads.items())
    assert all(torch.equal(r_after[n], v) for n, v in after.items())


def _forward_calls(monkeypatch, remat):
    """Calls of each forward launch function in the forward pass and in the
    backward pass of one training-mode loss of the tiny model."""
    torch.set_num_threads(1)
    calls, phase = collections.Counter(), ["forward"]
    for mod, name in FORWARDS:
        def counted(*args, _fn=getattr(mod, name), _name=name):
            calls[phase[0], _name] += 1
            return _fn(*args)
        monkeypatch.setattr(mod, name, counted)
    cfg = tt._tiny(variant_config("XS"))
    model = create_model(cfg, dtype=torch.float32, device="cpu", seed=0,
                         remat=remat).train()
    x = next(synthetic_batches(cfg, tt.B, seed=1, device="cpu",
                               dtype=torch.float32))["video"]
    logits = model(x, return_logits=True)
    phase[0] = "backward"
    logits.square().sum().backward()
    monkeypatch.undo()
    return {p: {n: calls[p, n] for _, n in FORWARDS}
            for p in ("forward", "backward")}


def test_convs_runs_no_conv_again_in_the_backward(monkeypatch):
    """Under "convs" no kernel's forward runs in the backward pass but those
    the backward itself launches (K7 for dx), as without remat; under
    "block" every block's convs run once more."""
    off = _forward_calls(monkeypatch, "off")
    convs = _forward_calls(monkeypatch, "convs")
    block = _forward_calls(monkeypatch, "block")
    assert convs == off
    # the stem's K1 and conv_5's K7 are outside every block
    stem_head = {"depthwise_conv3d": 1, "pw_conv": 1}
    again = {n: c - stem_head.get(n, 0) for n, c in off["forward"].items()}
    assert all(c > 0 for c in again.values())
    assert block["forward"] == off["forward"]
    assert block["backward"] == {n: off["backward"][n] + again[n]
                                 for n in again}
    assert off["backward"]["pw_conv"] > 0
    assert sum(off["backward"].values()) == off["backward"]["pw_conv"]


def test_library_calls_hold_in_their_own_thread_only():
    """A "convs" region sends only its own thread's kernel forwards through
    the ``x3d::`` ops, as its checkpoint's dispatch mode holds only there:
    another thread's eager forward meanwhile calls the kernels directly."""
    seen = []
    with ops.library_calls():
        assert ops.via_library()
        other = threading.Thread(target=lambda: seen.append(
            ops.via_library()))
        other.start()
        other.join()
    assert seen == [False]
    assert not ops.via_library()


def test_convs_step_matches_jax_convs_step():
    setup = tt._setup(False, remat="convs")
    assert setup["model"].remat == "convs"
    assert tt._port(setup)[1].remat == "convs"
    tt._assert_step(setup, "sgd")


def _stats_args(op, dtype):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 3, 5, 7, 8), generator=g).to(dtype)
    w = torch.randn((12, 8), generator=g)
    if op == "pw_conv_stats":
        return x, w
    return x, torch.rand((8, 2), generator=g), \
        torch.rand((8, 2), generator=g) - 0.5, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["pw_conv_stats", "pw_act_conv_stats"])
def test_stats_ops_fakes_match_the_kernels_outputs(op, dtype):
    """``x3d::pw_conv_stats`` and ``x3d::pw_act_conv_stats``: the fake
    versions give the real outputs' shapes, dtypes and strides, the ops
    return the launch functions' values, and opcheck passes."""
    args = _stats_args(op, dtype)
    real = getattr(library, op)(*args)
    assert all(torch.equal(a, b) for a, b in
               zip(real, getattr(pw_stats, op)(*args)))
    with FakeTensorMode() as mode:
        fake = getattr(library, op)(*(mode.from_tensor(a) for a in args))
    assert len(fake) == len(real) == 3
    for f, r in zip(fake, real):
        assert (f.shape, f.dtype, f.stride()) == (r.shape, r.dtype,
                                                  r.stride())
    assert real[0].dtype == dtype and real[1].dtype == torch.float32
    torch.library.opcheck(getattr(library, op), args,
                          test_utils=("test_schema", "test_faketensor"))
    assert getattr(torch.ops.x3d, op).default in library.OPS
