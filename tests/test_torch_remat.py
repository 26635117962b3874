"""Rematerialisation in the port's model against the JAX package's modes.

``TPU.REMAT`` (``x3d_tpu/models/x3d.py:747-757``, ``:797-812``): "block"
(or True) recomputes each ResBlock's forward in the backward pass, "stage"
each stage's; "auto" is "block" at ``TRAIN_CROP_SIZE >= 312`` (X3D-L and
-XL), off otherwise.  A step with remat must be the step without it, bit
for bit: the same loss, gradients and updated parameters, and the BN
running statistics folded once (the recompute takes the same batch
statistics and skips the update).  Tiny XS geometry of
``test_torch_train`` (T 4, 32², batch 2) with dropout 0.5, whose mask is
drawn in the head, outside every recomputed region; the kernels' plain
versions on the CPU, float32 and bfloat16.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

import test_torch_train as tt
from x3d_tpu import variant_config as jax_variant_config
from x3d_tpu.models import create_model as jax_create_model
from x3d_tpu_torch import variant_config
from x3d_tpu_torch.data import synthetic_batches
from x3d_tpu_torch.models import create_model
from x3d_tpu_torch.models.x3d import BatchNorm, ResBlock
from x3d_tpu_torch.tools.common import setup_runtime
from x3d_tpu_torch.train import create_train_state, make_train_step

VARIANTS = ("XS", "S", "M", "L", "XL")


def _step(remat, dtype):
    """One training step of the tiny model from seed 0: (loss, gradients,
    state dict after the step, forward calls of each ResBlock)."""
    torch.set_num_threads(1)
    cfg = tt._tiny(variant_config("XS"), dropout=0.5)
    model = create_model(cfg, dtype=dtype, device="cpu", seed=0, remat=remat)
    calls = {}
    for name, m in model.named_modules():
        if isinstance(m, ResBlock):
            m.register_forward_pre_hook(
                lambda *_, n=name: calls.__setitem__(n, calls.get(n, 0) + 1))
    state = create_train_state(cfg, model)
    batch = next(synthetic_batches(cfg, tt.B, seed=1, device="cpu",
                                   dtype=dtype))
    state, metrics = make_train_step(model, cfg.NETWORK.WEIGHT_DECAY)(
        state, batch, torch.Generator().manual_seed(3))
    assert not any(m.recomputing for m in model.modules()
                   if isinstance(m, BatchNorm))
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return metrics["loss"].item(), grads, model.state_dict(), calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("remat", [True, "block", "stage"])
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


def test_convs_remat_raises_not_implemented():
    """The JAX package's "convs" policy keeps conv outputs by name; the
    port's kernels launch inside autograd Functions that a checkpoint
    policy cannot name, so the mode is refused (ROADMAP A16)."""
    with pytest.raises(NotImplementedError, match="convs"):
        create_model(variant_config("L"), device="meta", remat="convs")
