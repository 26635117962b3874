"""The port's bfloat16 path against the JAX package's, on converted weights.

Both packages compute in bfloat16 on the main path; this file holds the
port's bf16 results against the JAX package's, on the CPU, with the JAX
model on its default (unfused) composition and the port on its fused
structure through the kernels' plain versions.  Every check runs at float32
and at bfloat16 on both sides.

* Eval: logits and view-averaged probabilities of ``test_torch_model``'s
  tiny config (T 5, 32², 2 videos x 2 views, random non-trivial BN), seeds
  0-3.
* Training: three SGD steps of ``make_train_step`` on both sides, tiny XS
  geometry (T 4, 64², batch 8, dropout 0), random non-trivial BN as in
  ``test_torch_train``; each step compares the train-mode logits, the whole
  gradient tree (relative L2, and the angle whose cosine the two trees
  make), the SGD update (the change of every parameter in the step) and
  the change of the BN running statistics in the step.

The tolerance rule.  The truth is JAX's float32 result; e_jax is JAX bf16's
distance from it on the same input, measured here.  Two paths that round
independently sit about sqrt(2) times one path's error apart, so the port's
bf16 result must be within 2·e_jax of JAX's float32 result AND within
2·e_jax of JAX's bf16 result.  Distances are relative L2 (over the whole
tree for gradients, updates and statistics) and, for the gradient's
direction, the angle in radians.  The port's float32 result must sit within
e_jax / 2 of JAX's float32 one, so that the gap measured is bf16 rounding
and not a float32 difference (the training step is badly conditioned at
these sizes in both packages: float32 sums in another order move step 2's
gradients by 0.27 e_jax).

Measured (the port's bf16 distance over e_jax, against JAX's float32 /
JAX's bf16 result): eval logits 0.87 / 1.16, 0.92 / 1.03, 0.77 / 0.74,
1.10 / 1.13 (seeds 0-3), probabilities at most 1.37 / 1.37; the three
training steps' logits, gradients, angles, updates and statistics at most
1.17 / 1.23, gradients 1.01-1.09 / 1.03-1.05, with e_jax 0.23, 0.33, 0.40
on the gradients (default BN variables give the same conditioning).
Before the port's BatchNorm applied its affine in float32 with one
rounding, as Flax's ``nn.BatchNorm`` does, it rounded the coefficients, the
product and the sum to bf16 each: eval logits then sat up to 1.39 / 1.61,
probabilities up to 1.95 / 2.26 (seed 1 failed the rule) and the steps'
quantities up to 1.36 / 1.43 (:func:`test_batchnorm_rounds_once_as_flax`
holds the module itself).  Weights come from the port's seeded
initialisation (the JAX package's initialisers), converted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_model as tm
import test_torch_train as tt
from x3d_tpu import get_default_config as jax_default_config
from x3d_tpu import variant_config as jax_variant_config
from x3d_tpu.models import create_model as jax_create_model
from x3d_tpu.ops import dw_fused as jax_dw_fused
from x3d_tpu.train import l2_penalty as jax_l2_penalty
from x3d_tpu.train import make_train_step as jax_make_train_step
from x3d_tpu.train.state import TrainState as JaxTrainState
from x3d_tpu.train.state import make_optimizer as jax_make_optimizer
from x3d_tpu_torch import convert, get_default_config, variant_config
from x3d_tpu_torch.models import create_model
from x3d_tpu_torch.train import create_train_state, make_train_step

FACTOR = 2.0             # the port's bf16 distance over e_jax, at most
F32_SHARE = 0.5          # the port's float32 distance over e_jax, at most
SEEDS = (0, 1, 2, 3)
TB, TS, STEPS = 8, 96, 3


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _angle(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
    return float(np.arccos(np.clip(cos, -1.0, 1.0)))


def _check(name, measure, f32_jax, bf16_jax, f32_port, bf16_port):
    """Assert the rule for one quantity; returns the port's two factors."""
    e_jax = measure(bf16_jax, f32_jax)
    assert e_jax > 0, name
    to_f32 = measure(bf16_port, f32_jax) / e_jax
    to_bf16 = measure(bf16_port, bf16_jax) / e_jax
    f32_gap = measure(f32_port, f32_jax) / e_jax
    assert to_f32 <= FACTOR and to_bf16 <= FACTOR, (
        f"{name}: port bf16 {to_f32:.3f} / {to_bf16:.3f} x e_jax "
        f"({e_jax:.3e}) from JAX f32 / bf16")
    assert f32_gap <= F32_SHARE, (
        f"{name}: port f32 {f32_gap:.3e} x e_jax from JAX f32")
    return to_f32, to_bf16


# ------------------------------------------------------------ BatchNorm


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_batchnorm_rounds_once_as_flax(train):
    """The port's BatchNorm in bf16 against Flax's ``nn.BatchNorm`` (the
    JAX package's ``_BN`` on its default path): both apply the affine in
    float32 and round once, so they agree to the last bit but where float32
    sums in another order put a value on the other side of a rounding
    boundary -- at most one bf16 ulp, at fewer than 1% of the elements
    (measured: none in eval, 0.06% in training).  Rounding the
    coefficients, the product and the sum to bf16 each (the port before
    this test) put 38% (eval) and 41% (training) of the elements off, by
    up to 2275 and 3930 ulps where the affine cancels to near zero."""
    from flax import linen as nn
    from x3d_tpu_torch.models.x3d import BatchNorm

    rng = np.random.default_rng(0)
    C = 24
    x = (rng.normal(size=(4, 3, 6, 6, C)) * 2 + 0.5).astype(np.float32)
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.normal(0, 0.3, C).astype(np.float32)
    mean = rng.normal(0, 0.2, C).astype(np.float32)
    var = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=not train, momentum=0.9,
                      epsilon=1e-5, dtype=jnp.bfloat16,
                      param_dtype=jnp.float32)
    want, _ = bn.apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean, "var": var}},
        jnp.asarray(x, jnp.bfloat16), mutable=["batch_stats"])
    want = np.asarray(want.astype(jnp.float32))
    port = BatchNorm(C, 1e-5, 0.9, torch.bfloat16)
    with torch.no_grad():
        for name, v in (("scale", scale), ("bias", bias), ("mean", mean),
                        ("var", var)):
            getattr(port.norm, name).copy_(torch.from_numpy(v))
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x).bfloat16()).float().numpy()
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    off = np.abs(got - want) / ulp
    assert off.max() <= 1.0, off.max()
    assert (off > 0).mean() < 0.01, (off > 0).mean()


def test_affine_gradients_match_float32():
    """The bf16 affine's one-pass backward against autograd of the same
    affine in float32 on the same values: dx within one rounding to bf16
    (2^-8 of the largest |dx|), dmul within 2^-9 of the sum of |g x| (its
    products are rounded to bf16 before the float32 sum), dadd within 1e-6
    of the sum of |g| (the same float32 sum in another order)."""
    from x3d_tpu_torch.models.x3d import affine

    gen = torch.Generator().manual_seed(0)
    x = torch.randn((3, 4, 5, 6, 24), generator=gen).bfloat16()
    g = torch.randn((3, 4, 5, 6, 24), generator=gen).bfloat16()
    mul = (torch.rand(24, generator=gen) + 0.5).requires_grad_()
    add = torch.randn(24, generator=gen).requires_grad_()
    xb = x.clone().requires_grad_()
    affine(xb, mul, add, torch.bfloat16).backward(g)
    got = (xb.grad.float(), mul.grad.clone(), add.grad.clone())
    mul.grad = add.grad = None
    x32 = x.float().requires_grad_()
    (x32 * mul + add).backward(g.float())
    dims = (0, 1, 2, 3)
    assert xb.grad.dtype == torch.bfloat16
    assert (got[0] - x32.grad).abs().max() <= 2.0 ** -8 * x32.grad.abs().max()
    bound = (g.float() * x.float()).abs().sum(dims)
    assert ((got[1] - mul.grad).abs() <= 2.0 ** -9 * bound).all()
    assert ((got[2] - add.grad).abs()
            <= 1e-6 * g.float().abs().sum(dims)).all()


# ------------------------------------------------------------------ eval


_jax_eval = {}


def _jax_logits(model, variables, x):
    fn = _jax_eval.setdefault(id(model), jax.jit(lambda v, x_: model.apply(
        v, x_, train=False, return_logits=True)))
    return np.asarray(fn(variables, x), np.float32)


def _probs(logits):
    """The JAX head's softmax and view average on float32 logits."""
    p = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    return np.asarray(p.reshape(-1, tm.VIEWS, tm.CLASSES).mean(axis=1))


@pytest.fixture(scope="module")
def eval_models():
    cfg = tm._tiny(jax_default_config())
    return {dt: jax_create_model(cfg, dtype=dt)
            for dt in (jnp.float32, jnp.bfloat16)}


def _weights(cfg, seed):
    """A Flax variable tree from the port's seeded initialisation (the JAX
    package's initialisers; no JAX init to compile)."""
    model = create_model(cfg, dtype=torch.float32, device="cpu", seed=seed)
    return convert.state_dict_to_flax(
        {k: v.detach() for k, v in model.state_dict().items()})


def eval_results(models, seed):
    """{(side, dtype): (logits, probs)} on one seed's weights and clips."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(tm.VIDEOS * tm.VIEWS, tm.T, tm.S, tm.S, 3)) \
        .astype(np.float32)
    variables = tm.randomize_bn(
        _weights(tm._tiny(get_default_config()), seed), rng)
    old = jax_dw_fused.get_enabled()
    jax_dw_fused.set_enabled(False)
    try:
        out = {}
        for dt, name in ((jnp.float32, "f32"), (jnp.bfloat16, "bf16")):
            logits = _jax_logits(models[dt], variables, x)
            out["jax", name] = (logits, _probs(logits))
    finally:
        jax_dw_fused.set_enabled(old)
    state = convert.flax_to_state_dict(variables)
    for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        port = create_model(tm._tiny(get_default_config()), dtype=dt,
                            device="cpu", init=False)
        port.load_state_dict(state)
        with torch.inference_mode():
            logits = port(torch.from_numpy(x), return_logits=True)
            probs = port(torch.from_numpy(x))
        out["port", name] = (logits.float().numpy(), probs.numpy())
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_eval_bf16_matches_jax(eval_models, seed):
    r = eval_results(eval_models, seed)
    for i, what in enumerate(("logits", "probabilities")):
        _check(f"seed {seed} {what}", _rel, r["jax", "f32"][i],
               r["jax", "bf16"][i], r["port", "f32"][i], r["port", "bf16"][i])


# -------------------------------------------------------------- training


def _train_cfg(cfg):
    cfg = tt._tiny(cfg)
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = TS
    cfg.TRAIN.BATCH_SIZE = TB
    cfg.TRAIN.DATASET_SIZE = TB * 4
    return cfg


def _flat(tree):
    leaves = tt._leaves(tree)
    return np.concatenate([leaves[k].ravel() for k in sorted(leaves)])


def _jax_steps(dtype, params, stats, batch, wd):
    """Per step: (train-mode logits, gradients, update, statistics change),
    each flattened over its whole tree."""
    cfg = _train_cfg(jax_variant_config("XS"))
    model = jax_create_model(cfg, dtype=dtype)
    tx = jax_make_optimizer(cfg, cfg.TRAIN.DATASET_SIZE // TB)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    state = JaxTrainState(step=jnp.asarray(0), params=params,
                          batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                             stats),
                          opt_state=tx.init(params), tx=tx)
    key = jax.random.PRNGKey(0)

    def loss_fn(p, s):
        # make_train_step's loss (x3d_tpu/train/steps.py:54-66), for the
        # logits and gradients the step does not return
        logits, _ = model.apply(
            {"params": p, "batch_stats": s}, batch["video"], train=True,
            return_logits=True, rngs={"dropout": key},
            mutable=["batch_stats"])
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), batch["label"]).mean()
        return ce + wd * jax_l2_penalty(p), logits

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    step = jax.jit(jax_make_train_step(model, wd))
    out = []
    for _ in range(STEPS):
        (_, logits), grads = grad_fn(state.params, state.batch_stats)
        new, _ = step(state, batch, key)
        delta = lambda a, b: jax.tree_util.tree_map(  # noqa: E731
            lambda u, v: np.asarray(u, np.float64) - np.asarray(v, np.float64),
            a, b)
        out.append((np.asarray(logits, np.float32).ravel(), _flat(grads),
                    _flat(delta(new.params, state.params)),
                    _flat(delta(new.batch_stats, state.batch_stats))))
        state = new
    return out


def _port_steps(dtype, params, stats, batch, wd):
    cfg = _train_cfg(variant_config("XS"))
    model = create_model(cfg, dtype=dtype, device="cpu", init=False)
    model.load_state_dict(convert.flax_to_state_dict(
        {"params": params, "batch_stats": stats}))
    state = create_train_state(cfg, model)
    step = make_train_step(model, wd)
    seen = {}
    model.fc_2.register_forward_hook(
        lambda m, i, o: seen.__setitem__("logits", o.detach()))

    def trees():
        tree = convert.state_dict_to_flax(
            {k: v.detach().double() for k, v in model.state_dict().items()})
        return _flat(tree["params"]), _flat(tree["batch_stats"])

    out = []
    video = torch.from_numpy(np.array(batch["video"]))
    label = torch.from_numpy(np.asarray(batch["label"], np.int64))
    for _ in range(STEPS):
        p0, s0 = trees()
        state, _ = step(state, {"video": video, "label": label},
                        torch.Generator().manual_seed(0))
        p1, s1 = trees()
        grads = convert.state_dict_to_flax(
            {n: p.grad for n, p in model.named_parameters()})["params"]
        out.append((seen["logits"].float().numpy().ravel(), _flat(grads),
                    p1 - p0, s1 - s0))
    return out


@pytest.fixture(scope="module")
def train_results():
    torch.set_num_threads(1)
    cfg = _train_cfg(jax_variant_config("XS"))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(TB, tt.T, TS, TS, 3)).astype(np.float32)
    label = rng.integers(0, tt.CLASSES, TB)
    variables = _weights(_train_cfg(variant_config("XS")), 0)
    params, stats = tt._randomize_bn(variables["params"],
                                     variables["batch_stats"], rng)
    batch = {"video": jnp.asarray(x), "label": jnp.asarray(label)}
    wd = cfg.NETWORK.WEIGHT_DECAY
    torch_dt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    out = {}
    for dt, name in ((jnp.float32, "f32"), (jnp.bfloat16, "bf16")):
        out["jax", name] = _jax_steps(dt, params, stats, batch, wd)
        out["port", name] = _port_steps(torch_dt[dt], params, stats, batch,
                                        wd)
    return out


TRAIN_CHECKS = [("logits", 0, _rel), ("gradients", 1, _rel),
                ("gradient angle", 1, _angle), ("update", 2, _rel),
                ("running statistics", 3, _rel)]


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("what,index,measure", TRAIN_CHECKS,
                         ids=[c[0] for c in TRAIN_CHECKS])
def test_train_step_bf16_matches_jax(train_results, step, what, index,
                                     measure):
    r = train_results
    _check(f"step {step} {what}", measure,
           *(r[side, dt][step][index] for side, dt in (
               ("jax", "f32"), ("jax", "bf16"), ("port", "f32"),
               ("port", "bf16"))))
