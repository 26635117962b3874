"""The port's ``fit`` and ``evaluate`` against the JAX package's, on the
same batches and converted weights, and the hooks' call order and cadences.

Tiny XS geometry (``C1_CHANNELS=4, DEPTH_FACTOR=0.34``, 10 classes), T=4,
32² crop, batch 2, dropout 0, float32 on the CPU, SGD-Nesterov.  Both loops
run three steps over an epoch boundary (2 steps per epoch, entered at step
1 of epoch 0 through the resume offset), each step on its own batch.

Tolerances (float32; the two packages sum in other orders): each step's
loss rtol 1e-5; the final parameters within 3e-4 of their leaf's largest
total update plus 1e-6 of the leaf's largest value (the train-step test's
bound of 1e-4 of the gradient's scale, once for each of the three steps);
the running statistics within 1e-5 of their leaf's largest value;
``evaluate``'s loss rtol 1e-5, its accuracies and count equal.  The learning rates handed to ``on_epoch_start`` rtol 1e-6.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x3d_tpu import variant_config as jax_variant_config
from x3d_tpu.models import create_model as jax_create_model
from x3d_tpu.train import create_train_state as jax_create_train_state
from x3d_tpu.train import hooks as jax_hooks
from x3d_tpu.train import loop as jax_loop
from x3d_tpu.train import make_eval_step as jax_make_eval_step
from x3d_tpu.train import make_train_step as jax_make_train_step
from x3d_tpu_torch import convert, variant_config
from x3d_tpu_torch.models import create_model
from x3d_tpu_torch.train import (create_train_state, hooks, loop,
                                 lr_for_epoch, make_eval_step,
                                 make_train_step)

B, T, S, CLASSES, STEPS_PER_EPOCH = 2, 4, 32, 10, 2


def _tiny(cfg):
    cfg.NETWORK.C1_CHANNELS = 4
    cfg.NETWORK.DEPTH_FACTOR = 0.34
    cfg.NETWORK.NUM_CLASSES = CLASSES
    cfg.NETWORK.DROPOUT_RATE = 0.0
    cfg.DATA.TEMP_DURATION = T
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = S
    cfg.TEST.NUM_TEMPORAL_VIEWS = 1
    cfg.TEST.NUM_SPATIAL_CROPS = 1
    cfg.TRAIN.DATASET_SIZE = 64
    cfg.TRAIN.BATCH_SIZE = B
    return cfg


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


class Recorder:
    """Records every hook call; bound to either package's ``Hook``."""

    def __init__(self):
        self.calls, self.lrs, self.losses = [], [], []

    def on_epoch_start(self, epoch, lr):
        self.calls.append(("epoch_start", epoch))
        self.lrs.append(lr)

    def on_step(self, step, metrics):
        self.calls.append(("step", step))
        self.losses.append((step, metrics["loss"]))

    def on_step_end(self, step, state):
        self.calls.append(("step_end", step, int(state.step)))

    def on_epoch_end(self, epoch, state, train_metrics, val_metrics):
        self.calls.append(("epoch_end", epoch, sorted(train_metrics),
                           None if val_metrics is None
                           else sorted(val_metrics)))

    def on_train_end(self):
        self.calls.append(("train_end",))


@pytest.fixture(scope="module")
def both():
    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    batches = [{"video": rng.normal(size=(B, T, S, S, 3)).astype(np.float32),
                "label": rng.integers(0, CLASSES, B)} for _ in range(3)]
    jcfg = _tiny(jax_variant_config("XS"))
    jmodel = jax_create_model(jcfg, dtype=jnp.float32)
    jstate = jax_create_train_state(
        jcfg, jmodel, jax.random.PRNGKey(0), jnp.asarray(batches[0]["video"]),
        steps_per_epoch=STEPS_PER_EPOCH)

    cfg = _tiny(variant_config("XS"))
    model = create_model(cfg, dtype=torch.float32, device="cpu", init=False)
    model.load_state_dict(convert.flax_to_state_dict(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    state = create_train_state(cfg, model, steps_per_epoch=STEPS_PER_EPOCH)
    return types.SimpleNamespace(
        batches=batches, jcfg=jcfg, jmodel=jmodel, jstate=jstate, cfg=cfg,
        model=model, state=state, initial=_leaves(jstate.params))


def _jax_batches(batches):
    return iter([{k: jnp.asarray(v) for k, v in b.items()} for b in batches])


def _torch_batches(batches):
    return iter([{k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
                 for b in batches])


def test_fit_matches_jax_over_an_epoch_boundary(both):
    kw = dict(steps_per_epoch=STEPS_PER_EPOCH, epochs=2, initial_epoch=0,
              initial_step_in_epoch=1, metrics_every=1)
    jrec = type("R", (Recorder, jax_hooks.Hook), {})()
    jval = lambda: _jax_batches(both.batches[:2])            # noqa: E731
    jnew = jax_loop.fit(
        both.jcfg, both.jstate,
        jax.jit(jax_make_train_step(both.jmodel,
                                    both.jcfg.NETWORK.WEIGHT_DECAY)),
        _jax_batches(both.batches), rng=jax.random.PRNGKey(0),
        eval_step=jax.jit(jax_make_eval_step(both.jmodel)),
        val_batches_fn=jval, hooks=[jrec], **kw)

    rec = type("R", (Recorder, hooks.Hook), {})()
    new = loop.fit(
        both.cfg, both.state,
        make_train_step(both.model, both.cfg.NETWORK.WEIGHT_DECAY),
        _torch_batches(both.batches), seed=0,
        eval_step=make_eval_step(both.model),
        val_batches_fn=lambda: _torch_batches(both.batches[:2]),
        hooks=[rec], **kw)
    assert new is both.state and new.step == 3 == int(jnew.step)
    both.jtrained = jnew

    # the same calls in the same order, with the same steps and epochs
    assert rec.calls == jrec.calls
    assert [c[0] for c in rec.calls] == [
        "epoch_start", "step", "step_end", "epoch_end",
        "epoch_start", "step", "step_end", "step", "step_end", "epoch_end",
        "train_end"]
    np.testing.assert_allclose(rec.lrs, jrec.lrs, rtol=1e-6)
    assert rec.lrs == [lr_for_epoch(both.cfg, 0), lr_for_epoch(both.cfg, 1)]
    # the schedule took --steps_per_epoch: the last step ran at epoch 1's LR
    assert new.optimizer.param_groups[0]["lr"] == lr_for_epoch(both.cfg, 1)

    assert [s for s, _ in rec.losses] == [2, 3, 4]
    np.testing.assert_allclose([v for _, v in rec.losses],
                               [v for _, v in jrec.losses], rtol=1e-5)

    tree = convert.state_dict_to_flax(both.model.state_dict())
    got, want = _leaves(tree["params"]), _leaves(jnew.params)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        moved = np.abs(w - both.initial[k]).max()
        np.testing.assert_allclose(
            got[k], w, rtol=0, atol=3e-4 * moved + 1e-6 * np.abs(w).max(),
            err_msg=k)
    got, want = _leaves(tree["batch_stats"]), _leaves(jnew.batch_stats)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)


def test_evaluate_matches_jax(both):
    """On the states as ``fit`` left them (or the initial ones when this
    test runs alone), and on a dataset whose last batch is smaller."""
    jstate = getattr(both, "jtrained", both.jstate)
    batches = both.batches[:2] + [{k: v[:1] for k, v in
                                   both.batches[2].items()}]
    want = jax_loop.evaluate(jax_make_eval_step(both.jmodel), jstate,
                             _jax_batches(batches))
    got = loop.evaluate(make_eval_step(both.model), both.state,
                        _torch_batches(batches))
    assert sorted(got) == sorted(want) == ["acc", "count", "loss",
                                           "top_5_acc"]
    assert got["count"] == want["count"] == 5.0
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got["acc"] == pytest.approx(want["acc"], abs=1e-7)
    assert got["top_5_acc"] == pytest.approx(want["top_5_acc"], abs=1e-7)
    assert all(isinstance(v, float) for v in got.values())
    empty = loop.evaluate(make_eval_step(both.model), both.state, iter([]))
    assert empty == jax_loop.evaluate(None, None, iter([]))


class _Saves:
    def __init__(self):
        self.keys = []

    def save(self, key, state):
        self.keys.append((int(key), int(state.step)))


def _count_only(state, batch, _):
    state.step += 1
    return state, {"loss": torch.tensor(0.5)}


@pytest.mark.parametrize("every,want", [
    (None, [3, 6]),              # epoch ends only
    (2, [2, 3, 4, 6]),           # both cadences; step 6 is saved once
    (3, [3, 6]),                 # the cadences coincide
])
def test_checkpoint_cadences_match_jax(both, every, want):
    """CheckpointHook under ``fit``: 2 epochs of 3 steps."""
    def run(fit, hook_cls, state, seed_kw):
        saves = _Saves()
        fit(both.cfg, state, _count_only, iter([{}] * 6), steps_per_epoch=3,
            epochs=2, hooks=[hook_cls(saves, every_n_steps=every)],
            metrics_every=50, **seed_kw)
        return saves.keys

    both.state.step = 0
    got = run(loop.fit, hooks.CheckpointHook, both.state, {"seed": 0})
    jgot = run(jax_loop.fit, jax_hooks.CheckpointHook,
               types.SimpleNamespace(step=0), {"rng": None})
    assert got == jgot == [(k, k) for k in want]


def test_metrics_are_fetched_at_the_cadence_only(both):
    """``on_step`` fires at ``metrics_every`` and at each epoch's last step;
    ``on_step_end`` fires every step."""
    rec = type("R", (Recorder, hooks.Hook), {})()
    both.state.step = 0
    loop.fit(both.cfg, both.state, _count_only, iter([{}] * 10),
             steps_per_epoch=5, epochs=2, seed=0, hooks=[rec],
             metrics_every=4)
    assert [c[1] for c in rec.calls if c[0] == "step"] == [4, 5, 8, 10]
    assert [c[1] for c in rec.calls if c[0] == "step_end"] == list(
        range(1, 11))


def test_steps_per_epoch_reaches_the_schedule(both):
    state = create_train_state(both.cfg, both.model, steps_per_epoch=3)
    assert state.schedule(2) == lr_for_epoch(both.cfg, 0)
    assert state.schedule(3) == lr_for_epoch(both.cfg, 1)
    default = create_train_state(both.cfg, both.model)   # 64 // 2 steps
    assert default.schedule(31) == lr_for_epoch(both.cfg, 0)
    assert default.schedule(32) == lr_for_epoch(both.cfg, 1)


def test_logging_hook_rate_window(caplog):
    """The steps/s window restarts at an epoch boundary with its step
    origin, as the JAX package's does."""
    import logging
    hook = hooks.LoggingHook(log_every=2)
    with caplog.at_level(logging.INFO, logger=hooks.log.name):
        hook.on_epoch_start(0, 0.1)
        for step in (1, 2):
            hook.on_step_end(step, None)
        hook.on_step(2, {"loss": 1.0, "acc": 0.5})
        hook.on_epoch_end(1, None, {"loss": 1.0}, {"acc": 0.25})
    text = caplog.text
    assert "epoch 0 starting, lr=0.100000" in text
    assert "step 2: acc=0.5000 loss=1.0000" in text and "steps/s" in text
    assert "epoch 1 done: loss=1.0000 | val: acc=0.2500" in text
