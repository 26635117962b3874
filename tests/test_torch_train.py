"""The port's training step against the JAX package's, on converted weights.

Tiny XS geometry (``C1_CHANNELS=4, DEPTH_FACTOR=0.34``, 10 classes), T=4,
32² crop, batch 2, dropout 0, float32 on the CPU.  The JAX model runs its
default (unfused) composition; the port runs its training path -- the
fused segment, the pointwise convs with BN sums and the SE gate folded into
bn_b's columns -- through the kernels' plain versions.  BN scales, offsets
and running statistics are random and non-trivial, with offsets of both
signs.  One step of ``make_train_step`` on each side is compared: the
loss, every gradient (through ``convert.state_dict_to_flax``), the updated
parameters and the BN running statistics.

Tolerances (float32; the two paths sum in other orders and the port takes
the BN statistics from the kernels' sums): loss rtol 1e-6; each gradient
within 1e-4 of its leaf's largest |gradient|; the running statistics
within 1e-6 of their leaf's largest value.  Updated parameters: SGD's step
is linear in the gradient, so within 1e-4 · lr of the gradient's leaf
scale plus 2.4e-7 of the leaf's largest value (two float32 ulps: the
update is rounded into the parameter); Adam's first step moves a weight by lr · g / (|g| + eps), about
±lr, so where g is rounding noise its sign may flip -- compared where |g|
exceeds 1e-3 of the leaf's largest |g| (within 1e-3 · lr), and bounded
by 2 lr elsewhere.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from x3d_tpu import variant_config as jax_variant_config
from x3d_tpu.models import create_model as jax_create_model
from x3d_tpu.train import create_train_state as jax_create_train_state
from x3d_tpu.train import l2_penalty as jax_l2_penalty
from x3d_tpu.train import lr_for_epoch as jax_lr_for_epoch
from x3d_tpu.train import make_eval_step as jax_make_eval_step
from x3d_tpu.train import make_train_step as jax_make_train_step
from x3d_tpu_torch import convert, variant_config
from x3d_tpu_torch.data import synthetic_batches
from x3d_tpu_torch.models import create_model
from x3d_tpu_torch.train import (create_train_state, l2_penalty,
                                 lr_for_epoch, make_eval_step,
                                 make_lr_schedule, make_train_step)

B, T, S, CLASSES = 2, 4, 32, 10


def _tiny(cfg, optimizer="sgd", dropout=0.0, scale_res2=False):
    if scale_res2:
        # X3D-XL's branch of the plan (test_torch_model._tiny)
        cfg.NETWORK.SCALE_RES2 = True
        cfg.NETWORK.WIDTH_FACTOR = 2.9
    cfg.NETWORK.C1_CHANNELS = 4
    cfg.NETWORK.DEPTH_FACTOR = 0.34
    cfg.NETWORK.NUM_CLASSES = CLASSES
    cfg.NETWORK.DROPOUT_RATE = dropout
    cfg.DATA.TEMP_DURATION = T
    cfg.DATA.TRAIN_CROP_SIZE = S
    cfg.DATA.TEST_CROP_SIZE = S
    cfg.TEST.NUM_TEMPORAL_VIEWS = 1
    cfg.TEST.NUM_SPATIAL_CROPS = 1
    cfg.TRAIN.DATASET_SIZE = 8
    cfg.TRAIN.BATCH_SIZE = B
    cfg.TRAIN.OPTIMIZER = optimizer
    return cfg


def _randomize_bn(params, stats, rng):
    """scale in [0.5, 1.5], offsets and means of both signs, variances in
    [0.5, 1.5]; returns numpy trees."""
    def walk(p, s):
        out_p, out_s = {}, {}
        for k, v in p.items():
            if k == "norm":
                c = v["scale"].shape
                out_p[k] = {"scale": rng.uniform(0.5, 1.5, c),
                            "bias": rng.normal(0, 0.3, c)}
                out_s[k] = {"mean": rng.normal(0, 0.2, c),
                            "var": rng.uniform(0.5, 1.5, c)}
            elif hasattr(v, "items"):
                out_p[k], sub = walk(v, s.get(k, {}))
                if sub:
                    out_s[k] = sub
            else:
                out_p[k] = np.asarray(v)
        return out_p, out_s
    p, s = walk(params, stats)
    f32 = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: np.asarray(a, np.float32), t)
    return f32(p), f32(s)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _setup(scale_res2, remat=None):
    """JAX's side of a step: the model (``remat`` None: the config's), its
    state with random BN, the batch, the loss and gradients."""
    torch.set_num_threads(1)
    cfg = _tiny(jax_variant_config("XS"), scale_res2=scale_res2)
    model = jax_create_model(cfg, dtype=jnp.float32, remat=remat)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, T, S, S, 3)).astype(np.float32)
    label = np.array([3, 7])
    state = jax_create_train_state(cfg, model, jax.random.PRNGKey(0),
                                   jnp.asarray(x))
    params, stats = _randomize_bn(state.params, state.batch_stats, rng)
    batch = {"video": jnp.asarray(x), "label": jnp.asarray(label)}
    wd = cfg.NETWORK.WEIGHT_DECAY

    def loss_fn(p):
        logits, _ = model.apply(
            {"params": p, "batch_stats": stats}, batch["video"], train=True,
            return_logits=True, rngs={"dropout": jax.random.PRNGKey(1)},
            mutable=["batch_stats"])
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits, batch["label"]).mean()
        return ce + wd * jax_l2_penalty(p)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return dict(cfg=cfg, model=model, state=state, params=params,
                stats=stats, x=x, label=label, batch=batch,
                loss=float(loss), grads=_leaves(grads),
                scale_res2=scale_res2, remat=remat)


@pytest.fixture(scope="module")
def setup():
    return _setup(False)


@pytest.fixture(scope="module")
def setup_scale_res2():
    return _setup(True)


def _port(setup, optimizer="sgd", dropout=0.0):
    cfg = _tiny(variant_config("XS"), optimizer, dropout,
                setup["scale_res2"])
    model = create_model(cfg, dtype=torch.float32, device="cpu", init=False,
                         remat=setup["remat"])
    model.load_state_dict(convert.flax_to_state_dict(
        {"params": setup["params"], "batch_stats": setup["stats"]}))
    return cfg, model, create_train_state(cfg, model)


def _batch(setup):
    return {"video": torch.from_numpy(setup["x"]),
            "label": torch.from_numpy(setup["label"])}


def _assert_leaves(got, want, tol, what):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=tol * np.abs(w).max() + 1e-12,
                                   err_msg=f"{what} {k}")


def _assert_step(setup, optimizer):
    jcfg = _tiny(jax_variant_config("XS"), optimizer,
                 scale_res2=setup["scale_res2"])
    jstate = jax_create_train_state(
        jcfg, setup["model"], jax.random.PRNGKey(0), setup["batch"]["video"])
    params = jax.tree_util.tree_map(jnp.asarray, setup["params"])
    jstate = jstate.replace(
        params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, setup["stats"]),
        opt_state=jstate.tx.init(params))
    new, metrics = jax.jit(jax_make_train_step(
        setup["model"], jcfg.NETWORK.WEIGHT_DECAY))(
            jstate, setup["batch"], jax.random.PRNGKey(0))

    cfg, model, state = _port(setup, optimizer)
    step = make_train_step(model, cfg.NETWORK.WEIGHT_DECAY)
    state, port_metrics = step(state, _batch(setup),
                               torch.Generator().manual_seed(0))
    assert state.step == 1
    np.testing.assert_allclose(float(port_metrics["loss"]),
                               float(metrics["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(port_metrics["loss"]), setup["loss"],
                               rtol=1e-6)

    grads = _leaves(convert.state_dict_to_flax(
        {n: p.grad for n, p in model.named_parameters()})["params"])
    _assert_leaves(grads, setup["grads"], 1e-4, "grad")
    tree = convert.state_dict_to_flax(model.state_dict())
    _assert_leaves(_leaves(tree["batch_stats"]), _leaves(new.batch_stats),
                   1e-6, "running statistic")

    lr = state.schedule(0)
    got, want = _leaves(tree["params"]), _leaves(new.params)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g_ref = setup["grads"][k]
        if optimizer == "sgd":
            np.testing.assert_allclose(
                got[k], w, rtol=0, atol=1e-4 * lr * np.abs(g_ref).max()
                + 2.4e-7 * np.abs(w).max(), err_msg=k)
        else:
            clear = np.abs(g_ref) > 1e-3 * np.abs(g_ref).max()
            np.testing.assert_allclose(got[k][clear], w[clear], rtol=0,
                                       atol=1e-3 * lr, err_msg=k)
            assert np.abs(got[k] - w).max() <= 2 * lr + 1e-7, k


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_train_step_matches_jax(setup, optimizer):
    _assert_step(setup, optimizer)


def test_train_step_matches_jax_scale_res2(setup_scale_res2):
    arch = _port(setup_scale_res2)[1].arch
    assert arch.conv1_dim == 16
    assert [b[0].out_channels for b in arch.stages] == [16, 24, 48, 96]
    _assert_step(setup_scale_res2, "sgd")


def test_l2_penalty_matches_jax(setup):
    _, model, _ = _port(setup)
    got = float(l2_penalty(model).detach())
    want = float(jax_l2_penalty(setup["params"]))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    names = {n for n, _ in model.named_parameters()}
    counted = {n for n in names
               if n.split(".")[-1] in ("weight", "kernel")
               and "se_fc1" not in n}
    # every conv and dense kernel but se_fc1's; no bias, no BN variable
    assert any("se_fc1.weight" in n for n in names - counted)
    assert all(n.endswith((".bias", ".scale")) or "se_fc1" in n
               for n in names - counted)


@pytest.mark.parametrize("epoch", [0, 1, 17, 34, 35, 36, 100, 200, 255])
def test_lr_schedule_reference_values(epoch):
    cfg = variant_config("M")        # BASE_LR 0.05, WARMUP_LR 0.01, 35, 256
    t = cfg.TRAIN
    if epoch > t.WARMUP_EPOCHS:
        ref = t.BASE_LR * 0.5 * (math.cos(math.pi * epoch / t.EPOCHS) + 1)
    else:
        ref = t.WARMUP_LR + epoch * (t.BASE_LR - t.WARMUP_LR) / t.WARMUP_EPOCHS
    np.testing.assert_allclose(lr_for_epoch(cfg, epoch), ref, rtol=1e-5,
                               atol=1e-8)
    # float32 arithmetic as in the JAX schedule: equal to its last bits
    # but for the cosine's own rounding
    np.testing.assert_allclose(
        lr_for_epoch(cfg, epoch),
        float(jax_lr_for_epoch(jax_variant_config("M"), epoch)), rtol=1e-6)


def test_lr_warmup_boundary_and_staircase():
    """epoch == WARMUP_EPOCHS still takes the warmup line (== BASE_LR); the
    LR is constant within an epoch and step n reads schedule(n)."""
    cfg = variant_config("M")
    np.testing.assert_allclose(lr_for_epoch(cfg, 35), cfg.TRAIN.BASE_LR,
                               rtol=1e-6)
    assert lr_for_epoch(cfg, 36) < lr_for_epoch(cfg, 35)
    sched = make_lr_schedule(cfg, steps_per_epoch=10)
    vals = [sched(s) for s in [0, 5, 9, 10, 19, 350, 359, 360]]
    assert vals[0] == vals[1] == vals[2] != vals[3] == vals[4]
    assert vals[5] == vals[6] != vals[7]
    with pytest.raises(ValueError):
        make_lr_schedule(cfg, 0)


def test_schedule_sets_the_optimizer_lr(setup):
    cfg, model, state = _port(setup)
    state.schedule = make_lr_schedule(cfg, steps_per_epoch=1)
    step = make_train_step(model, 0.0)
    for n in range(2):
        state, _ = step(state, _batch(setup), torch.Generator().manual_seed(0))
        assert state.optimizer.param_groups[0]["lr"] == lr_for_epoch(cfg, n)


def test_dropout_draws_from_the_generator(setup):
    """With dropout 0.5 the loss is a function of (state, batch, the
    generator's seed): the same seed repeats it, another seed changes it;
    the mask comes from the step's own generator, not torch's global one."""
    def one_step(seed, global_seed):
        cfg, model, state = _port(setup, dropout=0.5)
        torch.manual_seed(global_seed)
        step = make_train_step(model, cfg.NETWORK.WEIGHT_DECAY)
        _, metrics = step(state, _batch(setup),
                          torch.Generator().manual_seed(seed))
        return float(metrics["loss"])

    first = one_step(1, 0)
    assert one_step(1, 123) == first
    assert one_step(2, 0) != first

    _, model, _ = _port(setup, dropout=0.5)
    model.train()
    with pytest.raises(ValueError, match="Generator"):
        model(torch.from_numpy(setup["x"]))


def test_eval_step_matches_jax(setup):
    _, model, state = _port(setup)
    got = make_eval_step(model)(state, _batch(setup))
    jstate = setup["state"].replace(
        params=jax.tree_util.tree_map(jnp.asarray, setup["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, setup["stats"]))
    want = jax.jit(jax_make_eval_step(setup["model"]))(jstate,
                                                       setup["batch"])
    assert float(got["count"]) == float(want["count"]) == B
    np.testing.assert_allclose(float(got["loss_sum"]),
                               float(want["loss_sum"]), rtol=1e-5)
    for k in ("acc_sum", "top_5_sum"):
        assert int(got[k]) == int(want[k]), k


def test_synthetic_batches():
    cfg = _tiny(variant_config("XS"))
    it = synthetic_batches(cfg, 3, steps=2, seed=5, device="cpu")
    first, second = list(it)
    assert first["video"].shape == (3, T, S, S, 3)
    assert first["video"].dtype == torch.bfloat16
    assert first["label"].shape == (3,) and first["label"].max() < CLASSES
    assert second["video"] is first["video"]
    again = next(synthetic_batches(cfg, 3, seed=5, device="cpu"))
    assert torch.equal(again["video"], first["video"])
    cfg.TEST.NUM_TEMPORAL_VIEWS = 2
    ev = next(synthetic_batches(cfg, 3, is_training=False, device="cpu",
                                dtype=torch.float32))
    assert ev["video"].shape == (6, T, S, S, 3) and ev["label"].shape == (3,)
