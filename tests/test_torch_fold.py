"""The time-folded layout (``time_fold``) in the port, against the JAX
package's ``tests/test_fold.py`` semantics.

JAX carries activations as (B·T, 1, H, W, C) to fill a TPU's lanes.  On
a GPU that tensor is the NDHWC (B, T, H, W, C) one's memory, so the port
takes the options, checks them as JAX does and runs its one body.  So:

* ``ops.depthwise.depthwise_conv3d_folded`` equals JAX's at kt 3 and 5,
  T below and above kt, float32 within 1e-5 of the largest |y| (the convs
  sum in another order), and the port's unfolded conv bit for bit;
* the port's folded model (``fold_stages`` 0, 2, 4; ``bn_groups`` 1, 2;
  three JAX train-step compiles, about 15 s each here) equals JAX's folded
  model at ``test_fold.py``'s tolerances (loss rtol
  1e-5, parameters after the step rtol 2e-4 / atol 1e-6, running
  statistics rtol 1e-4 / atol 1e-6, eval probabilities rtol 1e-5 / atol
  1e-6), and the port's unfolded model bit for bit in float32 and
  bfloat16, with the same ATen calls;
* ``resolve_time_fold``, the two errors, the engine's five settings,
  ``tools.common.setup_runtime`` (the fold leaves remat to the config)
  and ``bench_serving --fold``.

Tiny XS geometry of ``test_torch_train`` (T 4, 32², 10 classes), on the
CPU through the kernels' plain versions.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import test_torch_train as tt
from x3d_tpu import variant_config as jax_variant_config
from x3d_tpu.models import create_model as jax_create_model
from x3d_tpu.models.x3d import resolve_time_fold as jax_resolve_time_fold
from x3d_tpu.ops.depthwise import \
    depthwise_conv3d_folded as jax_depthwise_folded
from x3d_tpu.train import create_train_state as jax_create_train_state
from x3d_tpu.train import make_train_step as jax_make_train_step
from x3d_tpu_torch import convert, variant_config
from x3d_tpu_torch.data import synthetic_batches
from x3d_tpu_torch.models import create_model
from x3d_tpu_torch.models.x3d import resolve_time_fold
from x3d_tpu_torch.ops import depthwise
from x3d_tpu_torch.serving import LAYOUTS, InferenceEngine
from x3d_tpu_torch.tools import bench_serving, common
from x3d_tpu_torch.train import create_train_state, make_train_step

VIEWS = 2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfg(jax_side=False, batch=tt.B):
    cfg = tt._tiny(jax_variant_config("XS") if jax_side
                   else variant_config("XS"))
    cfg.TEST.NUM_TEMPORAL_VIEWS = VIEWS
    cfg.TRAIN.BATCH_SIZE = batch
    return cfg


# ------------------------------------------------------------- the conv


@pytest.mark.parametrize("strides", [(1, 1, 1), (1, 2, 2)])
@pytest.mark.parametrize("kt,T", [(3, 4), (3, 2), (5, 4), (5, 2), (3, 1)])
def test_depthwise_folded_matches_jax(kt, T, strides):
    rng = np.random.default_rng(kt * 10 + T)
    B, H, W, C = 2, 6, 5, 4
    x = rng.normal(size=(B * T, 1, H, W, C)).astype(np.float32)
    k = rng.normal(size=(kt, 3, 3, 1, C)).astype(np.float32)
    want = np.asarray(jax_depthwise_folded(jnp.asarray(x), jnp.asarray(k),
                                           T, strides))
    xt = torch.from_numpy(x)
    got = depthwise.depthwise_conv3d_folded(xt, torch.from_numpy(k), T,
                                            strides)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    unfolded = depthwise.depthwise(xt.view(B, T, H, W, C),
                                   torch.from_numpy(k), strides)
    assert torch.equal(got, unfolded.view(got.shape))
    assert got._base is not None          # a view of the conv's output


def test_depthwise_folded_refuses_as_jax():
    x = torch.zeros((4, 1, 5, 5, 3))
    k = torch.zeros((3, 3, 3, 1, 3))
    with pytest.raises(ValueError, match="temporal stride 1"):
        depthwise.depthwise_conv3d_folded(x, k, 2, (2, 1, 1))
    with pytest.raises(ValueError, match="expected folded"):
        depthwise.depthwise_conv3d_folded(x, k, 3)
    with pytest.raises(ValueError, match="expected folded"):
        depthwise.depthwise_conv3d_folded(x.view(2, 2, 5, 5, 3), k, 2)
    with pytest.raises(ValueError, match="unsupported temporal padding"):
        depthwise.depthwise_conv3d_folded(
            x, k, 2, padding=((0, 2), (1, 1), (1, 1)))
    for args in ((jnp.zeros((4, 1, 5, 5, 3)), jnp.zeros((3, 3, 3, 1, 3)),
                  2, (2, 1, 1)),
                 (jnp.zeros((4, 1, 5, 5, 3)), jnp.zeros((3, 3, 3, 1, 3)),
                  3)):
        with pytest.raises(ValueError):
            jax_depthwise_folded(*args)


# ------------------------------------------------------- against JAX


@pytest.fixture(scope="module")
def jax_weights():
    """JAX's initial variables with random BN, as numpy trees."""
    cfg = _cfg(True)
    model = jax_create_model(cfg, dtype=jnp.float32, remat=False)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2 * tt.B, tt.T, tt.S, tt.S, 3)).astype(np.float32)
    state = jax_create_train_state(cfg, model, jax.random.PRNGKey(0),
                                   jnp.asarray(x))
    params, stats = tt._randomize_bn(state.params, state.batch_stats, rng)
    return params, stats


def _port_model(params, stats, **kw):
    cfg = _cfg(batch=kw.pop("batch", tt.B))
    model = create_model(cfg, dtype=torch.float32, device="cpu", init=False,
                         remat=False, **kw)
    model.load_state_dict(convert.flax_to_state_dict(
        {"params": params, "batch_stats": stats}))
    return cfg, model


@pytest.mark.parametrize("fold_stages", [0, 2, 4])
def test_folded_eval_matches_jax_folded(jax_weights, fold_stages):
    params, stats = jax_weights
    rng = np.random.default_rng(fold_stages)
    x = rng.normal(size=(2 * VIEWS, tt.T, tt.S, tt.S, 3)).astype(np.float32)
    model = jax_create_model(_cfg(True), dtype=jnp.float32, remat=False,
                             time_fold=True, fold_stages=fold_stages)
    want = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x)))
    _, port = _port_model(params, stats, time_fold=True,
                          fold_stages=fold_stages)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
        port.time_fold = False
        plain = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.array_equal(got, plain)


@pytest.mark.parametrize("fold_stages,bn_groups", [(0, 2), (2, 1), (4, 2)])
def test_folded_train_step_matches_jax_folded(jax_weights, fold_stages,
                                              bn_groups):
    params, stats = jax_weights
    B = 2 * tt.B
    rng = np.random.default_rng(10 + fold_stages)
    x = rng.normal(size=(B, tt.T, tt.S, tt.S, 3)).astype(np.float32)
    label = np.arange(B) % tt.CLASSES
    jcfg = _cfg(True, batch=B)
    model = jax_create_model(jcfg, dtype=jnp.float32, remat=False,
                             bn_groups=bn_groups, time_fold=True,
                             fold_stages=fold_stages)
    key = jax.random.PRNGKey(0)
    jstate = jax_create_train_state(jcfg, model, key, jnp.asarray(x))
    p = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jstate.replace(params=p, opt_state=jstate.tx.init(p),
                            batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                               stats))
    new, metrics = jax.jit(jax_make_train_step(
        model, jcfg.NETWORK.WEIGHT_DECAY))(
            jstate, {"video": jnp.asarray(x), "label": jnp.asarray(label)},
            key)

    cfg, port = _port_model(params, stats, time_fold=True,
                            fold_stages=fold_stages, bn_groups=bn_groups,
                            batch=B)
    state = create_train_state(cfg, port)
    state, port_metrics = make_train_step(port, cfg.NETWORK.WEIGHT_DECAY)(
        state, {"video": torch.from_numpy(x),
                "label": torch.from_numpy(label)},
        torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(port_metrics["loss"]),
                               float(metrics["loss"]), rtol=1e-5)
    tree = convert.state_dict_to_flax(port.state_dict())
    for what, rtol in (("params", 2e-4), ("batch_stats", 1e-4)):
        got, want = tt._leaves(tree[what]), tt._leaves(getattr(new, what))
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=rtol, atol=1e-6,
                                       err_msg=f"{what} {k}")


# ------------------------------------------------ folded vs unfolded


class _Calls(TorchDispatchMode):
    """Counts the ATen calls made under it."""

    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _bare_step(dtype, bn_groups, **fold):
    """One training step of the tiny model, from seed 0, and the ATen calls
    of its forward: (loss, gradients, state after, calls)."""
    cfg = _cfg(batch=tt.B * bn_groups)
    cfg.NETWORK.DROPOUT_RATE = 0.5
    model = create_model(cfg, dtype=dtype, device="cpu", seed=0,
                         remat=False, bn_groups=bn_groups, **fold)
    batch = next(synthetic_batches(cfg, tt.B * bn_groups, seed=1,
                                   device="cpu", dtype=dtype))
    state = create_train_state(cfg, model)
    state, metrics = make_train_step(model, cfg.NETWORK.WEIGHT_DECAY)(
        state, batch, torch.Generator().manual_seed(3))
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.eval()
    with torch.no_grad(), _Calls() as calls:
        probs = model(batch["video"][:VIEWS * 2])
    return (metrics["loss"].item(), grads, model.state_dict(), probs,
            calls)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("fold_stages,bn_groups", [(4, 1), (2, 1), (0, 2),
                                                   (4, 2)])
def test_folded_is_the_unfolded_model_bit_for_bit(dtype, fold_stages,
                                                  bn_groups):
    loss, grads, after, probs, calls = _bare_step(dtype, bn_groups,
                                                  time_fold=False)
    f_loss, f_grads, f_after, f_probs, f_calls = _bare_step(
        dtype, bn_groups, time_fold=True, fold_stages=fold_stages)
    assert f_loss == loss
    assert all(torch.equal(f_grads[n], g) for n, g in grads.items())
    assert all(torch.equal(f_after[n], v) for n, v in after.items())
    assert torch.equal(f_probs, probs)
    # the same ATen calls, views included: one body for every layout
    assert f_calls.calls == calls.calls


@pytest.mark.parametrize("fold_stages", [0, 2, 4])
def test_folded_model_runs_the_unfolded_body(fold_stages):
    cfg = _cfg()
    model = create_model(cfg, dtype=torch.float32, device="cpu", seed=0,
                         time_fold=True, fold_stages=fold_stages)
    seen = []
    for name in ("conv_1", "stage2_block0", "stage5_block0"):
        getattr(model, name).register_forward_pre_hook(
            lambda m, args, n=name: seen.append((n, args[0])))
    x = torch.randn(2 * VIEWS, tt.T, tt.S, tt.S, 3)
    with torch.no_grad():
        model(x)
    # the stem takes the input itself, and every stage (B, T, H, W, C)
    assert seen[0][1] is x
    assert all(t.shape[:2] == (2 * VIEWS, tt.T) for _, t in seen)


def test_time_fold_from_the_config_and_per_call():
    cfg = _cfg()
    assert cfg.TPU.TIME_FOLD == "auto"
    model = create_model(cfg, device="meta")
    assert (model.time_fold, model.fold_stages) == ("auto", 4)
    cfg.TPU.TIME_FOLD = True
    model = create_model(cfg, device="meta", fold_stages=2)
    assert (model.time_fold, model.fold_stages) == (True, 2)
    assert create_model(cfg, device="meta", time_fold=False).time_fold \
        is False


# --------------------------------------------------- rules and errors


@pytest.mark.parametrize("args", [
    (True, 480, 16, False), (False, 16, 16, True), ("auto", 16, 16, True),
    ("auto", 16, 16, False), ("auto", 8, 16, True), (16, 16, 16, True),
    (16, 8, 16, True), (16, 480, 16, True), (128, 48, 16, False),
    (16, 16, 16, False), (True, 2, 16, False), (False, 2, 16, False)])
def test_resolve_time_fold_as_jax(args):
    """``test_fold.py``'s table: the port answers as JAX does off a TPU."""
    assert resolve_time_fold(*args) is jax_resolve_time_fold(*args)


def test_the_two_errors_as_jax():
    cfg = _cfg(batch=4)
    model = create_model(cfg, dtype=torch.float32, device="cpu",
                         time_fold=True, bn_groups=3, remat=False)
    x = torch.zeros((4, tt.T, tt.S, tt.S, 3))
    model.train()
    with pytest.raises(ValueError, match="divisible by bn_groups 3"):
        model(x)
    jmodel = jax_create_model(_cfg(True), dtype=jnp.float32, remat=False,
                              bn_groups=3, time_fold=True)
    with pytest.raises(ValueError, match="divisible by bn_groups 3"):
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                           jnp.asarray(x.numpy()),
                                           train=True))
    model = create_model(cfg, dtype=torch.float32, device="cpu",
                         fold_stages=5)
    with pytest.raises(ValueError, match="fold_stages 5 not in 0..4"):
        model(x)
    jmodel = jax_create_model(_cfg(True), dtype=jnp.float32, fold_stages=5)
    with pytest.raises(ValueError, match="fold_stages 5 not in 0..4"):
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                           jnp.asarray(x.numpy())))


# ------------------------------------------------ engine and the tools


def test_engine_time_fold_settings():
    cfg = _cfg()
    base = InferenceEngine.random_init(cfg, max_videos=2, device="cpu",
                                       seed=0)
    clips = np.random.default_rng(0).integers(
        0, 256, (2 * VIEWS,) + base.clip_shape[1:], dtype=np.uint8)
    want = base.predict(clips)
    # None: fold where a request at capacity is at most 16 clips
    assert base.layout is True
    assert InferenceEngine(cfg, base.model, max_videos=9,
                           device="cpu").layout is False
    for setting, layout in ((True, True), (False, False),
                            ("mixed", "mixed"), (None, True)):
        engine = InferenceEngine(cfg, base.model, max_videos=2,
                                 device="cpu", time_fold=setting)
        assert engine.layout == layout
        assert np.array_equal(engine.predict(clips), want), setting
    # "measure": the layouts run one body and tie, so the first, unfolded
    measured = InferenceEngine(cfg, base.model, max_videos=2, device="cpu",
                               time_fold="measure")
    assert measured.layout is LAYOUTS[0] is False
    assert np.array_equal(measured.predict(clips), want)
    with pytest.raises(ValueError, match="time_fold 'sideways'"):
        InferenceEngine(cfg, base.model, device="cpu", time_fold="sideways")


@pytest.mark.parametrize("fold,crop,remat", [
    ("auto", 312, "block"), (True, 312, "block"), (16, 312, "block"),
    (False, 312, "block"), (True, 224, "off"), (16, 224, "off"),
    ("auto", 224, "off")])
def test_setup_runtime_takes_the_fold_and_the_config_remat(fold, crop,
                                                           remat):
    """``tools/common``: the model takes ``TPU.TIME_FOLD`` as it stands
    ("auto" folds nothing off a TPU) and ``TPU.REMAT`` "auto" as
    ``create_model`` resolves it, fold or not.  The JAX tools turn remat
    off where a run folds at 312² (folding shrinks a TPU's lane-padded
    activations); the port's fold saves no byte, so it keeps the remat."""
    cfg = _cfg()
    cfg.TPU.TIME_FOLD = fold
    cfg.DATA.TRAIN_CROP_SIZE = crop
    _, model, _ = common.setup_runtime(cfg, 1, mixed_precision=False,
                                       debug=False, device="cpu")
    assert (model.time_fold, model.remat) == (fold, remat)


@pytest.mark.parametrize("name,folds", [
    ("both", (False, True)), ("on", (True,)), ("off", (False,)),
    ("mixed", ("mixed",)), ("auto", (None,)), ("ALL", (False, True, "mixed"))])
def test_bench_serving_fold_parses(name, folds):
    args = bench_serving.build_parser().parse_args([f"--fold={name}"])
    assert bench_serving.FOLDS[args.fold] == folds


def test_bench_serving_fold_refuses_unknown():
    with pytest.raises(SystemExit):
        bench_serving.build_parser().parse_args(["--fold=sideways"])
    assert bench_serving.build_parser().parse_args([]).fold == "off"
