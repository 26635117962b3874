"""Which float32 step leaves float64 where the two packages' steps part
(ROADMAP C6), on the CPU.

``tests/test_torch_multigrid.py::test_fit_multigrid_matches_jax`` runs the
port's multigrid loop in lockstep with the JAX package's (each port step
from JAX's state before it) at ``tests/test_torch_train.py``'s one-step
tolerances, with its data drawn from seed 0.  Run with its data seed set to
each of 0-9 (``np.random.default_rng(seed)``, nothing else changed), it
fails at four of the forty steps and passes at the other 36:

=====  ====  ===============================================================
seed   step  what fails (worst leaf: error / bound)
=====  ====  ===============================================================
1      2     bn_5's running variance, 1.10
2      1     70 leaves upstream of stage4_block0: its bn_a scale's momentum
             trace, 29.5
3      1     172 leaves: fc_1's kernel trace, 347
9      3     bn_5's running variance, 1.84
=====  ====  ===============================================================

This file takes those steps, and step 1 of every seed, and computes the
same step a third time: the port's plain path rebuilt in float64 (a copy of
the package with ``torch.float32`` replaced by ``torch.float64`` in the
model, ops and train step, made in a temporary directory).  From the same
state and batch it holds each float32 result to the float64 one (measured
on the CPU):

* **Gradients** (loss with L2, every leaf, as a share of the leaf's largest
  float64 |gradient|).  The port stays within 1e-4 at every case, the
  one-step gradient tolerance of ``tests/test_torch_train.py``, and within
  2x JAX's distance; measured 5.4e-6 - 1.5e-5.  JAX leaves float64 by
  2.95e-3 at seed 2 and 3.47e-2 at seed 3, step 1: there a pre-activation
  sits within a few ulps of a ReLU's kink and JAX's float32 puts it on the
  other side of float64's.  At seed 3 it is one of fc_1's 16384 units (the
  head's kink the lockstep test's docstring named); at seed 2 it is one of
  stage4_block0's bn_a outputs, a kink in the trunk.  The port takes
  float64's side at both.  At the other cases JAX sits 1.1e-5 - 5.7e-5
  from float64, the port as near or nearer.
* **bn_5's batch variance** E[x²] - E[x]² over 8 or 16 values a channel.
  Taken in float32 by each package's own formula from its own conv_5
  output, against float64 from that same output, the two packages err
  alike: largest relative errors a case 8.3e-7 - 4.2e-6 (JAX) and 6.6e-7 -
  2.3e-6 (port), root mean squares over every channel of every case 2.6e-7
  and 2.5e-7 (held: the port's within 2x JAX's).  The packages' float32
  variances part exactly as far as float64 variances of their two conv_5
  outputs do (held within 8e-6 of the variance): the difference comes from
  upstream, where the two trunks sum in other orders, and a variance over 8
  values amplifies it.  Against the float64 forward's variance JAX's root
  mean square relative error is 3.0e-6 and the port's 1.1e-6 (held: the
  port's no larger).  So the bn_5 failures at seeds 1 and 9 are not in the
  port's variance: JAX's own float32 trunk is the further from float64.

So C6 is not a port fault.  The lockstep test keeps its seed and its
bounds; its docstring points here.  Tiny XS geometry as that test, float32
against float64, one thread; about 60 s (three JAX compiles).
"""

import os
import shutil
import sys

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
from x3d_tpu.train import make_train_step as jax_make_train_step
from x3d_tpu.train import multigrid as jax_multigrid
from x3d_tpu.train.state import make_optimizer as jax_make_optimizer
import x3d_tpu_torch.models as port_models
import x3d_tpu_torch.train as port_train
from x3d_tpu_torch import convert, variant_config
from x3d_tpu_torch.models.x3d import batch_stats
from x3d_tpu_torch.train import MultigridSchedule

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# step 1 of every seed, and the two later steps where the lockstep test
# fails on bn_5's running variance
CASES = [(seed, 1) for seed in range(10)] + [(1, 2), (9, 3)]
F64_NAME = "x3d_float64_port"
# the files whose float32 accumulations become float64 in the copy
F64_FILES = ("models/x3d.py", "ops/depthwise.py", "ops/dw_fused.py",
             "ops/epilogue.py", "ops/pointwise.py", "ops/pw_stats.py",
             "train/steps.py")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def tiny_cfg(make):
    """The lockstep test's configuration and phases."""
    cfg = make("XS")
    cfg.NETWORK.C1_CHANNELS = 4
    cfg.NETWORK.DEPTH_FACTOR = 0.34
    cfg.NETWORK.NUM_CLASSES = 10
    cfg.NETWORK.DROPOUT_RATE = 0.0
    cfg.TEST.NUM_TEMPORAL_VIEWS = 1
    cfg.TEST.NUM_SPATIAL_CROPS = 1
    cfg.DATA.TEMP_DURATION = 4
    cfg.DATA.TRAIN_CROP_SIZE = 32
    cfg.DATA.TRAIN_JITTER_SCALES = [36, 44]
    cfg.TRAIN.BATCH_SIZE = 2
    cfg.TRAIN.EPOCHS = 4
    cfg.MULTIGRID.SPATIAL_DIVISOR = 4
    cfg.MULTIGRID.LONG_CYCLE_FACTORS = [[0.5, 0.7071], [0.5, 1.0],
                                        [1.0, 1.0]]
    return cfg


def _randomize_bn(params, stats, rng):
    """The lockstep test's BN variables (same draws, same order)."""
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


@pytest.fixture(scope="module")
def f64(tmp_path_factory):
    """The port's package copied under another name, its float32
    accumulations made float64: the plain path computes in float64."""
    root = tmp_path_factory.mktemp("float64")
    dest = root / F64_NAME
    shutil.copytree(os.path.join(ROOT, "x3d_tpu_torch"), dest,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    for path in dest.rglob("*.py"):
        text = path.read_text().replace("x3d_tpu_torch", F64_NAME)
        if path.relative_to(dest).as_posix() in F64_FILES:
            assert "torch.float32" in text, path
            text = text.replace("torch.float32", "torch.float64")
        path.write_text(text)
    sys.path.insert(0, str(root))
    try:
        import importlib

        mods = {name: importlib.import_module(f"{F64_NAME}.{name}")
                for name in ("models", "convert", "train")}
    finally:
        sys.path.remove(str(root))
    yield mods
    for name in [m for m in sys.modules if m.split(".")[0] == F64_NAME]:
        del sys.modules[name]


@pytest.fixture(scope="module")
def jax_side():
    """The JAX model's starting state and its step, which also returns the
    step's gradients and its conv_5, fc_1 and bn_a outputs."""
    jcfg = tiny_cfg(jax_variant_config)
    model = jax_create_model(jcfg, dtype=jnp.float32)
    wd = jcfg.NETWORK.WEIGHT_DECAY

    def loss_fn(p, stats, video, label):
        logits, out = model.apply(
            {"params": p, "batch_stats": stats}, video, train=True,
            return_logits=True, mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda m, method: method == "__call__"
            and m.name in ("conv_5", "fc_1", "bn_a"))
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits, label).mean()
        return ce + wd * jax_l2_penalty(p), out["intermediates"]

    train_step = jax_make_train_step(model, wd)

    @jax.jit
    def step(state, video, label):
        """JAX's step from ``state`` (the lockstep test's JAX loop), and
        the gradients and outputs of the same step; one compile a shape."""
        (_, inter), g = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, state.batch_stats, video, label)
        x = inter["conv_5"]["__call__"][0]
        mean = jnp.mean(x, axis=(0, 1, 2, 3))
        # bn_5's batch variance as the JAX package takes it
        # (x3d_tpu/models/x3d.py:204)
        var = jnp.mean(jnp.square(x), axis=(0, 1, 2, 3)) - jnp.square(mean)
        new, _ = train_step(state, {"video": video, "label": label},
                            jax.random.PRNGKey(0))
        return new, (g, x, var, inter["fc_1"]["__call__"][0],
                     inter["stage4_block0"]["bottleneck"]["bn_a"]
                     ["__call__"][0])

    sched = jax_multigrid.MultigridSchedule(jcfg, 1, 4)
    state = jax_create_train_state(
        jcfg, model, jax.random.PRNGKey(0),
        jnp.zeros((1, 4, 32, 32, 3), jnp.float32),
        tx=jax_make_optimizer(jcfg, 1, schedule=sched.make_lr_schedule()))
    return dict(cfg=jcfg, sched=sched, state=state, step=step)


def _lockstep_start(seed, jax_side):
    """The lockstep test's data, schedule and starting state at ``seed``."""
    cfg = tiny_cfg(variant_config)
    sched = MultigridSchedule(cfg, 1, 4)
    assert sched.epoch_phase == jax_side["sched"].epoch_phase == [0, 1, 2, 2]
    rng = np.random.default_rng(seed)
    data = {}
    for p in sched.phases:
        n = sched.epoch_phase.count(p.index) * p.steps_per_epoch
        data[p.index] = [{
            "video": rng.normal(size=(p.batch_size, p.temp_duration,
                                      p.crop_size, p.crop_size, 3))
            .astype(np.float32),
            "label": rng.integers(0, 10, p.batch_size)} for _ in range(n)]
    jstate = jax_side["state"]
    params, stats = _randomize_bn(jstate.params, jstate.batch_stats, rng)
    # the batches in the order the loops draw them: one step an epoch
    batches = [data[0][0], data[1][0], data[2][0], data[2][1]]
    return cfg, sched, jstate.replace(
        params=params, batch_stats=stats,
        opt_state=jstate.tx.init(params)), batches


def _port_grads(models, conv, train, cfg, sched, tree, batch, dtype):
    """One step of a port package (the port or its float64 copy) from a
    Flax state: gradients as Flax leaves, conv_5's, fc_1's and
    stage4_block0's bn_a outputs."""
    model = models.create_model(cfg, dtype=dtype, device="cpu", init=False)
    model.load_state_dict({k: v.to(dtype) for k, v in conv.flax_to_state_dict(
        tree).items()})
    model.to(dtype)
    state = train.create_train_state(cfg, model,
                                     schedule=sched.make_lr_schedule())
    got = {}
    hooks = [getattr(model, name).register_forward_hook(
        lambda m, a, o, name=name: got.__setitem__(name, o.detach()))
        for name in ("conv_5", "fc_1")]
    hooks.append(model.stage4_block0.bottleneck.bn_a.register_forward_hook(
        lambda m, a, o: got.__setitem__("bn_a", o.detach())))
    video = torch.from_numpy(batch["video"]).to(dtype)
    train.make_train_step(model, cfg.NETWORK.WEIGHT_DECAY)(
        state, {"video": video, "label": torch.from_numpy(batch["label"])},
        torch.Generator().manual_seed(0))
    for h in hooks:
        h.remove()
    grads = _leaves(conv.state_dict_to_flax(
        {n: p.grad for n, p in model.named_parameters()})["params"])
    return grads, {k: v.numpy() for k, v in got.items()}


def _rel(a, b):
    return np.abs(a - b) / np.abs(b)


def test_port_is_no_further_from_float64_than_jax(f64, jax_side):
    rows = []
    var_sq = {"jax": [], "port": []}           # same-output errors, squared
    e2e_sq = {"jax": [], "port": []}           # against the float64 forward
    for seed, step in CASES:
        cfg, sched, jstate, batches = _lockstep_start(seed, jax_side)
        for b in batches[:step - 1]:           # JAX's state before the step
            jstate, _ = jax_side["step"](jstate, jnp.asarray(b["video"]),
                                         jnp.asarray(b["label"]))
        batch = batches[step - 1]
        tree = jax.device_get({"params": jstate.params,
                               "batch_stats": jstate.batch_stats})
        _, out = jax_side["step"](jstate, jnp.asarray(batch["video"]),
                                  jnp.asarray(batch["label"]))
        gj = _leaves(out[0])
        xj, var_j, fj, aj = (np.asarray(v) for v in out[1:])
        gp, outp = _port_grads(port_models, convert, port_train, cfg, sched,
                               tree, batch, torch.float32)
        g64, out64 = _port_grads(f64["models"], f64["convert"], f64["train"],
                                 cfg, sched, tree, batch, torch.float64)
        assert out64["conv_5"].dtype == np.float64
        assert sorted(gj) == sorted(gp) == sorted(g64)

        def grad_err(g):
            return max(np.abs(g[k] - v).max() / np.abs(v).max()
                       for k, v in g64.items())

        e_jax, e_port = grad_err(gj), grad_err(gp)

        # bn_5's batch variance: float32 by each package's formula from its
        # own conv_5 output, against float64 from that same output
        def var64(x):
            return x.astype(np.float64).reshape(-1, x.shape[-1]).var(axis=0)

        xp = outp["conv_5"]
        var_p = batch_stats(torch.from_numpy(xp))[1].numpy()
        same_j, same_p = _rel(var_j, var64(xj)), _rel(var_p, var64(xp))
        var_sq["jax"].append(same_j ** 2)
        var_sq["port"].append(same_p ** 2)
        # the packages' float32 variances part as far as float64 variances
        # of their two conv_5 outputs do: the difference is upstream
        v_true = var64(out64["conv_5"])
        np.testing.assert_allclose(
            _rel(var_p, var_j), np.abs(var64(xp) - var64(xj)) / var64(xj),
            rtol=0, atol=8e-6, err_msg=f"seed {seed} step {step}")
        e2e_sq["jax"].append(_rel(var_j, v_true) ** 2)
        e2e_sq["port"].append(_rel(var_p, v_true) ** 2)

        # pre-activations on the other side of a ReLU's kink from float64
        flips = {}
        for name, j in (("fc_1", fj), ("bn_a", aj)):
            ref = out64[name] > 0
            flips[name] = (int(((j > 0) != ref).sum()),
                           int(((outp[name] > 0) != ref).sum()))
        rows.append(dict(seed=seed, step=step, grad_jax=e_jax,
                         grad_port=e_port, flips=flips,
                         var_same_jax=float(same_j.max()),
                         var_same_port=float(same_p.max())))
        what = f"seed {seed} step {step}: {rows[-1]}"
        # the port within the one-step gradient tolerance of float64, and
        # never further from it than JAX by more than 2x
        assert e_port <= 1e-4, what
        assert e_port <= 2 * e_jax, what
        # the port takes float64's side of every kink of fc_1 and
        # stage4_block0's bn_a
        assert flips["fc_1"][1] == flips["bn_a"][1] == 0, what

    by = {(r["seed"], r["step"]): r for r in rows}
    # where the lockstep test fails at step 1, JAX's float32 leaves float64
    # through a unit that takes the other side of a kink
    assert by[(3, 1)]["flips"]["fc_1"][0] >= 1, by[(3, 1)]
    assert by[(2, 1)]["flips"]["bn_a"][0] >= 1, by[(2, 1)]
    for key in ((2, 1), (3, 1)):
        assert by[key]["grad_jax"] > 1e-3 > 1e-4 >= by[key]["grad_port"], \
            by[key]

    def rms(parts):
        return float(np.sqrt(np.concatenate(parts).mean()))

    # bn_5: from the same output the port's variance errs as JAX's does;
    # against the float64 forward the port's is the nearer
    assert rms(var_sq["port"]) <= 2 * rms(var_sq["jax"]), var_sq
    assert rms(e2e_sq["port"]) <= rms(e2e_sq["jax"]), (rms(e2e_sq["port"]),
                                                        rms(e2e_sq["jax"]))
