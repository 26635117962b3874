"""The port's long-cycle multigrid training against the JAX package's
(``x3d_tpu/train/multigrid.py``), on the CPU.

* The schedule, exactly: for the five variants' YAMLs and for
  hypothesis-drawn configs, the phases, the epoch assignment, the epochs'
  first steps, ``position_for_step`` at every step from 0 to the total + 1,
  and the LR at every step, bit for bit in float32, against
  ``jax.jit(schedule.make_lr_schedule())``.
* The analogues of ``tests/test_multigrid.py`` on the port's model.
* Precise BN against JAX on converted weights and the same three batches.
  Tolerance: each running statistic within 1e-5 of the larger of its
  leaf's largest value and the largest running value it was recovered
  against.  The two packages' batch statistics agree to about 1e-6 of that
  scale (float32, other summation orders; ``tests/test_torch_train.py``
  holds one step's running statistics, which take a tenth of a batch's,
  to 1e-6), and recovering a batch's statistic as (new - m*old)/(1 - m)
  multiplies the rounding of ``new`` (of the old value's size) by 1/(1 -
  m) = 10 at momentum 0.9.
* ``fit_multigrid`` against JAX's over three phases of distinct (B, T, S),
  the base phase revisited, in lockstep (each of the port's steps from
  JAX's state before it): the batches drawn, each step's LR bit for bit,
  and each step's loss, parameters, momentum trace and running statistics
  within ``tests/test_torch_train.py``'s one-step tolerances (the test's
  docstring says why free-running trajectories are not compared); the
  port's loop run freely equals its step over the same batches, bit for
  bit.
* The train tool's ``--multigrid`` on synthetic batches and on shards, a
  crash and resume in one process, and the refusal of
  ``--multigrid --native_loader``.

Tiny XS geometry (``C1_CHANNELS=4, DEPTH_FACTOR=0.34``), 32² crops or
smaller, dropout 0, float32, one thread.
"""

import logging
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from x3d_tpu import variant_config as jax_variant_config
from x3d_tpu.models import create_model as jax_create_model
from x3d_tpu.train import create_train_state as jax_create_train_state
from x3d_tpu.train import hooks as jax_hooks
from x3d_tpu.train import make_train_step as jax_make_train_step
from x3d_tpu.train import multigrid as jax_multigrid
from x3d_tpu.train.state import make_optimizer as jax_make_optimizer
from x3d_tpu_torch import convert, variant_config
from x3d_tpu_torch.models import create_model
from x3d_tpu_torch.models.x3d import BatchNorm
from x3d_tpu_torch.tools import train as train_cli
from x3d_tpu_torch.train import (MultigridSchedule, create_train_state,
                                 fit_multigrid, hooks, lr_for_epoch,
                                 make_bn_recalibrator, make_train_step)
from x3d_tpu_torch.train.loop import fit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ("XS", "S", "M", "L", "XL")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def tiny_cfg(make=variant_config):
    """``tests/test_multigrid.py``'s tiny config, in either package."""
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
    return cfg


def _model(cfg, seed=0):
    return create_model(cfg, dtype=torch.float32, device="cpu", seed=seed)


def synthetic_phase_batches(phase, num_classes=10, seed=0):
    gen = torch.Generator().manual_seed(seed + phase.index)
    video = torch.randn((phase.batch_size, phase.temp_duration,
                         phase.crop_size, phase.crop_size, 3), generator=gen)
    label = torch.randint(0, num_classes, (phase.batch_size,), generator=gen)
    while True:
        yield {"video": video, "label": label}


def _stats(model):
    return {n: b.clone() for n, b in model.named_buffers()}


def _load_stats(model, stats):
    with torch.no_grad():
        for n, b in model.named_buffers():
            b.copy_(stats[n])


# -------------------------------------------------- the schedule, exactly


def _phase_tuple(p):
    return (p.index, p.temp_duration, p.crop_size, tuple(p.jitter_scales),
            p.batch_size, p.lr_scale, p.steps_per_epoch)


def _assert_same_schedule(cfg, jcfg, base_steps, epochs):
    mine = MultigridSchedule(cfg, base_steps, epochs)
    want = jax_multigrid.MultigridSchedule(jcfg, base_steps, epochs)
    assert [_phase_tuple(p) for p in mine.phases] == \
        [_phase_tuple(p) for p in want.phases]
    assert mine.epoch_phase == want.epoch_phase
    assert mine.first_step.tolist() == want.first_step.tolist()
    assert mine.describe() == want.describe()
    total = mine.total_steps()
    assert total == want.total_steps()
    for step in range(total + 2):
        assert mine.position_for_step(step) == want.position_for_step(step)
    steps = np.arange(total + 2)
    want_lr = np.asarray(jax.jit(want.make_lr_schedule())(steps), np.float32)
    fn = mine.make_lr_schedule()
    got_lr = np.asarray([fn(s) for s in steps], np.float32)
    assert np.array_equal(got_lr.view(np.uint32), want_lr.view(np.uint32))
    for epoch in range(epochs):
        assert mine.lr_for_epoch_scaled(epoch) == \
            want.lr_for_epoch_scaled(epoch)
    return mine


@pytest.mark.parametrize("base_steps,epochs", [(8, 5), (8, None)],
                         ids=["8x5", "8xyaml"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_schedule_matches_jax_for_the_yamls(variant, base_steps, epochs):
    """The YAMLs' geometry and default factors: 5 epochs of 8 base steps
    (the phase table of X3D-M: (256, 4, 160), (128, 8, 160), (64, 8, 224),
    (32, 16, 224)) and the YAML's own epochs."""
    cfg, jcfg = variant_config(variant), jax_variant_config(variant)
    sched = _assert_same_schedule(cfg, jcfg, base_steps,
                                  epochs or cfg.TRAIN.EPOCHS)
    if variant == "M" and epochs == 5:
        assert [(p.batch_size, p.temp_duration, p.crop_size)
                for p in sched.phases] == [(256, 4, 160), (128, 8, 160),
                                           (64, 8, 224), (32, 16, 224)]
        assert sched.epoch_phase == [0, 1, 2, 3, 3]
        assert sched.first_step.tolist() == [0, 1, 3, 7, 15, 23]


_FACTOR = st.tuples(st.sampled_from([0.25, 0.3, 0.5, 0.75, 1.0]),
                    st.sampled_from([0.5, 0.6, 0.7071, 0.8, 1.0]))


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(epochs=st.integers(1, 40), base_steps=st.integers(1, 200),
       block=st.integers(1, 3), finetune=st.floats(0.0, 0.5),
       factors=st.lists(_FACTOR, min_size=0, max_size=3),
       T=st.integers(1, 16), S=st.sampled_from([32, 112, 160, 224, 312]),
       B=st.integers(1, 64), divisor=st.sampled_from([4, 8, 16]),
       jitter=st.sampled_from([[36, 44], [182, 228], [256, 320],
                               [356, 446]]))
def test_schedule_matches_jax_for_drawn_configs(epochs, base_steps, block,
                                                finetune, factors, T, S, B,
                                                divisor, jitter):
    cfg, jcfg = variant_config("M"), jax_variant_config("M")
    for c in (cfg, jcfg):
        c.MULTIGRID.EPOCH_BLOCK = block
        c.MULTIGRID.FINETUNE_FRACTION = finetune
        c.MULTIGRID.LONG_CYCLE_FACTORS = [list(f) for f in factors] \
            + [[1.0, 1.0]]
        c.MULTIGRID.SPATIAL_DIVISOR = divisor
        c.DATA.TEMP_DURATION = T
        c.DATA.TRAIN_CROP_SIZE = S
        c.DATA.TRAIN_JITTER_SCALES = list(jitter)
        c.TRAIN.BATCH_SIZE = B
    _assert_same_schedule(cfg, jcfg, base_steps, epochs)


# ------------------------------ analogues of tests/test_multigrid.py


def test_schedule_phase_geometry():
    """Default factors: 8/4/2/1 batch multipliers, T/S scaled, cost const."""
    cfg = variant_config("M")
    cfg.DATA.TEMP_DURATION = 16
    cfg.DATA.TRAIN_CROP_SIZE = 224
    cfg.DATA.TRAIN_JITTER_SCALES = [256, 320]
    cfg.TRAIN.BATCH_SIZE = 128
    sched = MultigridSchedule(cfg, base_steps_per_epoch=100, epochs=20)
    assert [p.batch_size // 128 for p in sched.phases] == [8, 4, 2, 1]
    assert [p.temp_duration for p in sched.phases] == [4, 8, 8, 16]
    assert sched.phases[0].crop_size == 160
    assert sched.phases[3].crop_size == 224
    assert sched.phases[3].jitter_scales == (256, 320)
    assert all(j >= p.crop_size for p in sched.phases
               for j in p.jitter_scales)
    for p in sched.phases:
        clips = p.batch_size * p.steps_per_epoch
        assert abs(clips - 128 * 100) / (128 * 100) < 0.05
        assert p.jitter_scales[0] < p.jitter_scales[1], p
    assert sched.epoch_phase[-2:] == [3, 3]
    assert sched.epoch_phase[:2] == [0, 0]
    assert sched.epoch_phase[2:18] == [0, 1, 2, 3] * 4


def test_cycle_always_ends_on_base_phase():
    cfg = tiny_cfg()
    for epochs in range(2, 30):
        for block in (1, 2, 3):
            cfg.MULTIGRID.EPOCH_BLOCK = block
            sched = MultigridSchedule(cfg, base_steps_per_epoch=8,
                                      epochs=epochs)
            n_base = len(sched.phases) - 1
            boundary = epochs - max(
                1, int(round(epochs * cfg.MULTIGRID.FINETUNE_FRACTION)))
            if boundary > 0:
                assert sched.epoch_phase[boundary - 1] == n_base
            prev = None
            for e in range(boundary):
                p = sched.epoch_phase[e]
                if prev is not None:
                    assert p >= prev or p == 0, sched.epoch_phase
                prev = p


def test_schedule_requires_base_shape_last():
    cfg = tiny_cfg()
    cfg.MULTIGRID.LONG_CYCLE_FACTORS = [[0.5, 1.0], [0.25, 0.7071]]
    with pytest.raises(ValueError):
        MultigridSchedule(cfg, base_steps_per_epoch=4, epochs=2)


def test_lr_schedule_linear_scaling_and_boundaries():
    cfg = variant_config("M")
    cfg.TRAIN.BATCH_SIZE = 128
    sched = MultigridSchedule(cfg, base_steps_per_epoch=80, epochs=12)
    lr_fn = sched.make_lr_schedule()
    for epoch in range(12):
        expect = lr_for_epoch(cfg, epoch) * sched.phase_for_epoch(
            epoch).lr_scale
        for step in (int(sched.first_step[epoch]),
                     int(sched.first_step[epoch + 1]) - 1):
            assert lr_fn(step) == float(np.float32(expect))
    total = sched.total_steps()
    assert lr_fn(total + 10) == lr_fn(total - 1)


def test_position_for_step_roundtrips():
    cfg = tiny_cfg()
    sched = MultigridSchedule(cfg, base_steps_per_epoch=8, epochs=6)
    for epoch in range(6):
        n = sched.phase_for_epoch(epoch).steps_per_epoch
        for i in sorted({0, n // 2, n - 1}):
            step = int(sched.first_step[epoch]) + i
            assert sched.position_for_step(step) == (epoch, i)
    assert sched.position_for_step(sched.total_steps()) == (6, 0)
    assert sched.position_for_step(sched.total_steps() + 7) == (6, 0)


def test_finished_run_resumes_as_noop():
    cfg = tiny_cfg()
    cfg.MULTIGRID.LONG_CYCLE_FACTORS = [[1.0, 1.0]]
    sched = MultigridSchedule(cfg, base_steps_per_epoch=2, epochs=2)
    state = create_train_state(cfg, _model(cfg), steps_per_epoch=2)
    fired = []

    class Record(hooks.Hook):
        def on_epoch_start(self, *a): fired.append("epoch_start")
        def on_step(self, *a): fired.append("step")
        def on_step_end(self, *a): fired.append("step_end")
        def on_epoch_end(self, *a): fired.append("epoch_end")
        def on_train_end(self): fired.append("train_end")

    def fail_batches(phase):
        raise AssertionError("a finished run must not build iterators")

    out = fit_multigrid(cfg, state, None, sched, fail_batches, seed=0,
                        initial_epoch=sched.epochs, hooks=[Record()])
    assert fired == ["train_end"]
    assert out is state


def test_single_phase_multigrid_matches_fit():
    """With factors [[1, 1]] the multigrid loop is the plain trainer, bit
    for bit."""
    cfg = tiny_cfg()
    cfg.MULTIGRID.LONG_CYCLE_FACTORS = [[1.0, 1.0]]
    epochs, steps = 2, 3
    sched = MultigridSchedule(cfg, base_steps_per_epoch=steps, epochs=epochs)
    model_a, model_b = _model(cfg), _model(cfg)
    state_a = create_train_state(cfg, model_a, steps_per_epoch=steps)
    state_b = create_train_state(cfg, model_b,
                                 schedule=sched.make_lr_schedule())
    fixed = next(synthetic_phase_batches(sched.phases[0]))
    state_a = fit(cfg, state_a, make_train_step(model_a, 5e-5),
                  iter(lambda: fixed, None), steps_per_epoch=steps,
                  epochs=epochs, seed=0)
    state_b = fit_multigrid(cfg, state_b, make_train_step(model_b, 5e-5),
                            sched, lambda phase: iter(lambda: fixed, None),
                            seed=0)
    assert state_a.step == state_b.step == epochs * steps
    for (k, a), b in zip(model_a.state_dict().items(),
                         model_b.state_dict().values()):
        assert torch.equal(a, b), k


class _Record(hooks.Hook):
    def __init__(self):
        self.epoch_lrs, self.step_lrs, self.steps = [], [], []

    def on_epoch_start(self, epoch, lr):
        self.epoch_lrs.append(lr)

    def on_step_end(self, step, state):
        self.steps.append(step)
        self.step_lrs.append(state.optimizer.param_groups[0]["lr"])


def test_fit_multigrid_walks_phases_and_counts_steps():
    cfg = tiny_cfg()
    cfg.MULTIGRID.LONG_CYCLE_FACTORS = [[0.5, 1.0], [1.0, 1.0]]
    sched = MultigridSchedule(cfg, base_steps_per_epoch=4, epochs=3)
    assert sched.epoch_phase == [0, 1, 1]
    assert sched.phases[0].batch_size == 4
    assert sched.phases[0].temp_duration == 2
    model = _model(cfg)
    state = create_train_state(cfg, model, schedule=sched.make_lr_schedule())
    seen_shapes, closed = [], []

    def batches_for_phase(phase):
        seen_shapes.append((phase.batch_size, phase.temp_duration,
                            phase.crop_size))
        try:
            yield from synthetic_phase_batches(phase)
        finally:
            closed.append(phase.index)

    rec = _Record()
    state = fit_multigrid(cfg, state, make_train_step(model, 5e-5), sched,
                          batches_for_phase, seed=1, hooks=[rec])
    assert seen_shapes == [(4, 2, 32), (2, 4, 32)]   # one iterator a phase
    assert sorted(closed) == [0, 1]                   # ... closed at the end
    assert state.step == sched.total_steps() == 2 + 4 + 4
    assert rec.steps == list(range(1, 11))
    assert rec.epoch_lrs[0] == lr_for_epoch(cfg, 0) * 2
    assert rec.epoch_lrs[1] == lr_for_epoch(cfg, 1)
    assert rec.step_lrs == [sched.make_lr_schedule()(s) for s in range(10)]
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_fit_multigrid_closes_its_iterators_when_a_step_raises():
    cfg = tiny_cfg()
    cfg.MULTIGRID.LONG_CYCLE_FACTORS = [[0.5, 1.0], [1.0, 1.0]]
    sched = MultigridSchedule(cfg, base_steps_per_epoch=4, epochs=3)
    state = create_train_state(cfg, _model(cfg),
                               schedule=sched.make_lr_schedule())
    closed = []

    def batches_for_phase(phase):
        try:
            yield from synthetic_phase_batches(phase)
        finally:
            closed.append(phase.index)

    def step(state, batch, gen):
        if batch["video"].shape[1] == 4:
            raise RuntimeError("step failed")
        state.step += 1
        return state, {"loss": torch.tensor(1.0)}

    with pytest.raises(RuntimeError, match="step failed"):
        fit_multigrid(cfg, state, step, sched, batches_for_phase, seed=0)
    assert sorted(closed) == [0, 1]


def _recal(model, batches, n, seed=2):
    return make_bn_recalibrator(model, lambda: iter(batches), n, seed,
                                momentum=0.9)


def test_bn_recalibrator_reestimates_stats():
    cfg = tiny_cfg()
    model = _model(cfg)
    state = create_train_state(cfg, model, steps_per_epoch=2)
    before = _stats(model)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    shifted = {"video": torch.full((2, 4, 32, 32, 3), 3.0)}
    out = _recal(model, [shifted] * 4, 4)(state)
    assert out is state and not model.training      # the mode is restored
    after = _stats(model)
    assert any(not torch.allclose(before[k], after[k]) for k in before)
    for n, p in model.named_parameters():
        assert torch.equal(p, params[n]), n


def test_bn_recalibration_is_exact_average_not_ema():
    """With identical batches the result does not depend on N, and a
    second recalibration from the recalibrated state is a fixed point."""
    cfg = tiny_cfg()
    model = _model(cfg)
    state = create_train_state(cfg, model, steps_per_epoch=2)
    batch = {"video": torch.randn((2, 4, 32, 32, 3),
                                  generator=torch.Generator().manual_seed(5))
             + 2.0}
    start = _stats(model)
    _recal(model, [batch] * 1, 1)(state)
    s1 = _stats(model)
    _load_stats(model, start)
    _recal(model, [batch] * 8, 8)(state)
    s8 = _stats(model)
    for k in s1:
        torch.testing.assert_close(s1[k], s8[k], rtol=1e-5, atol=1e-6)
    _load_stats(model, s1)
    _recal(model, [batch] * 2, 2)(state)
    for k, v in _stats(model).items():
        torch.testing.assert_close(v, s1[k], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("remat", ["off", "block"])
def test_bn_recalibration_replaces_every_batchnorm(remat):
    """One batch: every BatchNorm -- the stem's, the fused segments' bn_a,
    bn_b and bn_c (from the kernels' sums), the projections' bn_r and
    bn_5 -- ends at that batch's statistics, which a training forward at
    momentum 0 leaves in the buffers; with remat as without (no region
    recomputes without gradients).  Tolerance 1e-5 of the larger of the
    leaf's largest value and its largest starting value (the inversion's
    factor of 10 on float32 rounding)."""
    cfg = tiny_cfg()
    model = _model(cfg)
    model.remat = remat
    state = create_train_state(cfg, model, steps_per_epoch=2)
    batch = {"video": torch.randn((2, 4, 32, 32, 3),
                                  generator=torch.Generator().manual_seed(7))}
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    start = _stats(model)
    model.train()
    for bn in norms:
        bn.momentum = 0.0
    with torch.no_grad():
        model(batch["video"], return_logits=True)
    want = _stats(model)
    for bn in norms:
        bn.momentum = 0.9
    _load_stats(model, start)
    model.eval()
    _recal(model, [batch], 1)(state)
    got = _stats(model)
    assert len(norms) == sum(k.endswith(".norm.mean") for k in got)
    for k, w in want.items():
        assert not torch.equal(w, start[k]), k
        scale = max(w.abs().max().item(), start[k].abs().max().item())
        torch.testing.assert_close(got[k], w, rtol=0, atol=1e-5 * scale)
    assert not model.training


# -------------------------------------------------------- against JAX


def _randomize_bn(params, stats, rng):
    """BN scales in [0.5, 1.5], offsets and means of both signs, variances
    in [0.5, 1.5]; numpy trees."""
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


def test_bn_recalibration_matches_jax():
    rng = np.random.default_rng(0)
    jcfg, cfg = tiny_cfg(jax_variant_config), tiny_cfg()
    batches = [rng.normal(size=(2, 4, 32, 32, 3)).astype(np.float32) + i
               for i in range(3)]
    jmodel = jax_create_model(jcfg, dtype=jnp.float32)
    jstate = jax_create_train_state(jcfg, jmodel, jax.random.PRNGKey(0),
                                    jnp.asarray(batches[0]),
                                    steps_per_epoch=2)
    params, stats = _randomize_bn(jstate.params, jstate.batch_stats, rng)
    jstate = jstate.replace(params=params, batch_stats=stats)
    m = jcfg.NETWORK.BN.MOMENTUM
    want = jax_multigrid.make_bn_recalibrator(
        jmodel, lambda: iter([{"video": jnp.asarray(b)} for b in batches]),
        3, jax.random.PRNGKey(1), momentum=m)(jstate)

    model = create_model(cfg, dtype=torch.float32, device="cpu", init=False)
    model.load_state_dict(convert.flax_to_state_dict(
        {"params": params, "batch_stats": stats}))
    state = create_train_state(cfg, model, steps_per_epoch=2)
    _recal(model, [{"video": torch.from_numpy(b)} for b in batches], 3)(state)
    got = _leaves(convert.state_dict_to_flax(model.state_dict())
                  ["batch_stats"])
    want = _leaves(want.batch_stats)
    assert sorted(got) == sorted(want)
    old = _leaves(stats)
    for k, w in want.items():
        assert not np.array_equal(w, old[k]), k
        scale = max(np.abs(w).max(), np.abs(old[k]).max())
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-5 * scale,
                                   err_msg=k)


def _port_state(cfg, sched, params, stats):
    model = create_model(cfg, dtype=torch.float32, device="cpu", init=False)
    model.load_state_dict(convert.flax_to_state_dict(
        {"params": params, "batch_stats": stats}))
    return create_train_state(cfg, model, schedule=sched.make_lr_schedule())


def _torch_batch(b):
    return {"video": torch.from_numpy(b["video"]),
            "label": torch.from_numpy(b["label"])}


def _snapshot(tree):
    """Leaves of a ``train_state_to_flax``-shaped tree, copied."""
    return {part: {k: np.array(v) for k, v in _leaves(tree[part]).items()}
            for part in ("params", "batch_stats", "trace")}


def test_fit_multigrid_matches_jax():
    """Three phases of distinct (B, T, S) -- (8, 2, 24), (4, 2, 32), (2, 4,
    32) -- over four epochs [0, 1, 2, 2] of one step each (the base phase
    revisited, its iterator kept), a distinct batch every step, from the
    same weights with random BN variables.

    Free-running float32 trajectories of the tiny network are not
    comparable after a few steps: the two packages' head pre-activations
    (fc_1, 2048 a clip) differ by up to about 2e-5 of their spread, so in
    a sizeable share of draws one of them sits close enough to the ReLU's
    kink to take the other side in one package; that moves fc_1's update
    by percents and every later step amplifies it (JAX's own run on inputs
    nudged by 1e-6 parts moves as far).  So the loops are compared in
    lockstep: each step of the port's ``fit_multigrid`` starts from JAX's
    state before the same step (loaded when the loop draws the step's
    batch) and is held to ``tests/test_torch_train.py``'s one-step
    tolerances against JAX's state after it: the loss rtol 1e-6; the
    running statistics within 1e-6 of their leaf's largest value; the
    momentum trace within 1e-4 of the leaf's largest |g| (g = new trace -
    momentum * old trace, the step's gradient with weight decay); the
    parameters within 1e-4 * lr * (1 + momentum) of the same scale
    (Nesterov applies g twice) plus 2.4e-7 of the leaf's largest value.
    The data are drawn from seed 0 (as ``tests/test_torch_loop.py``'s).
    Over data seeds 0-9 this test fails at 4 of 40 steps: seed 3 at step 1
    (fc_1's update off by percents), seed 2 at step 1 (70 leaves upstream
    of stage4_block0), seeds 1 and 9 at steps 2 and 3 (bn_5's running
    variance, 1.1x and 1.8x its bound).  At each of them it is JAX's
    float32 step that leaves float64, not the port's
    (``tests/test_torch_float64_reference.py``, ROADMAP C6): at seeds 3 and
    2 a pre-activation within a few ulps of a ReLU's kink (one of fc_1's
    units; one of stage4_block0's bn_a outputs) takes the other side of
    float64's in JAX, and at seeds 1 and 9 JAX's conv_5 output is the
    further from float64, which a variance over 8 values a channel
    amplifies; the port's gradients stay within 1.5e-5 of float64.  Both
    loops draw the same batches in the same order, hand out the same LRs
    (bit for bit) and run the same global steps; and the port's loop, run
    freely, equals the port's step applied to those batches in that order,
    bit for bit: the state it carries from step to step is the step's
    own."""
    jcfg, cfg = tiny_cfg(jax_variant_config), tiny_cfg()
    for c in (jcfg, cfg):
        c.MULTIGRID.LONG_CYCLE_FACTORS = [[0.5, 0.7071], [0.5, 1.0],
                                          [1.0, 1.0]]
    jsched = jax_multigrid.MultigridSchedule(jcfg, 1, 4)
    sched = MultigridSchedule(cfg, 1, 4)
    assert [(p.batch_size, p.temp_duration, p.crop_size)
            for p in sched.phases] == [(8, 2, 24), (4, 2, 32), (2, 4, 32)]
    assert sched.epoch_phase == jsched.epoch_phase == [0, 1, 2, 2]
    total = sched.total_steps()
    rng = np.random.default_rng(0)
    data = {}
    for p in sched.phases:
        n = sched.epoch_phase.count(p.index) * p.steps_per_epoch
        data[p.index] = [{
            "video": rng.normal(size=(p.batch_size, p.temp_duration,
                                      p.crop_size, p.crop_size, 3))
            .astype(np.float32),
            "label": rng.integers(0, 10, p.batch_size)} for _ in range(n)]

    jmodel = jax_create_model(jcfg, dtype=jnp.float32)
    jstate = jax_create_train_state(
        jcfg, jmodel, jax.random.PRNGKey(0),
        jnp.zeros((1, 4, 32, 32, 3), jnp.float32),
        tx=jax_make_optimizer(jcfg, 1, schedule=jsched.make_lr_schedule()))
    params, stats = _randomize_bn(jstate.params, jstate.batch_stats, rng)
    jstate = jstate.replace(params=params, batch_stats=stats)

    # JAX's loop: the batches it draws, each step's loss and state after it
    jrec = types.SimpleNamespace(lrs=[], losses={}, order=[], states=[])

    class JRecord(jax_hooks.Hook):
        def on_epoch_start(self, epoch, lr):
            jrec.lrs.append(lr)

        def on_step(self, step, metrics):
            jrec.losses[step] = metrics["loss"]

        def on_step_end(self, step, state):
            tree = jax.device_get({
                "step": state.step, "params": state.params,
                "batch_stats": state.batch_stats,
                "trace": state.opt_state[0].trace})
            jrec.states.append(tree)

    def jbatches(p):
        for j, b in enumerate(data[p.index]):
            jrec.order.append((p.index, j))
            yield {k: jnp.asarray(v) for k, v in b.items()}

    jnew = jax_multigrid.fit_multigrid(
        jcfg, jstate, jax.jit(jax_make_train_step(
            jmodel, jcfg.NETWORK.WEIGHT_DECAY)), jsched, jbatches,
        rng=jax.random.PRNGKey(0), hooks=[JRecord()])
    assert int(jnew.step) == total == 4 == len(jrec.states)
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    before = [{"step": 0, "params": params, "batch_stats": stats,
               "trace": zeros}] + jrec.states[:-1]

    # The port's loop in lockstep: each step from JAX's state before it
    state = _port_state(cfg, sched, params, stats)
    order, got = [], []

    def lockstep(p):
        for j, b in enumerate(data[p.index]):
            tree = before[len(order)]
            convert.train_state_from_flax(
                {**tree, "opt_state": {"trace": tree["trace"]}}, state)
            order.append((p.index, j))
            yield _torch_batch(b)

    class Record(_Record):
        def __init__(self):
            super().__init__()
            self.losses = {}

        def on_step(self, step, metrics):
            self.losses[step] = metrics["loss"]

        def on_step_end(self, step, state):
            super().on_step_end(step, state)
            tree = convert.train_state_to_flax(state)
            got.append({**_snapshot({**tree,
                                     "trace": tree["opt_state"]["trace"]}),
                        "step": tree["step"]})

    rec = Record()
    out = fit_multigrid(cfg, state, make_train_step(
        state.model, cfg.NETWORK.WEIGHT_DECAY), sched, lockstep, seed=0,
        hooks=[rec])
    assert out is state and state.step == total
    assert order == jrec.order
    assert rec.steps == sorted(jrec.losses) == list(range(1, total + 1))
    assert rec.epoch_lrs == jrec.lrs
    jlr = np.asarray(jax.jit(jsched.make_lr_schedule())(np.arange(total)))
    assert rec.step_lrs == [float(v) for v in jlr]

    mom = cfg.TRAIN.MOMENTUM
    for i, (g, w, b) in enumerate(zip(got, jrec.states, before)):
        what = f"step {i + 1}"
        assert g["step"] == int(w["step"]) == i + 1, what
        np.testing.assert_allclose(rec.losses[i + 1], jrec.losses[i + 1],
                                   rtol=1e-6, err_msg=what)
        want = _snapshot(w)
        old_trace = _leaves(b["trace"])
        assert sorted(g["params"]) == sorted(want["params"])
        for k, v in want["batch_stats"].items():
            np.testing.assert_allclose(
                g["batch_stats"][k], v, rtol=0,
                atol=1e-6 * np.abs(v).max() + 1e-12,
                err_msg=f"{what} running statistic {k}")
        for k, v in want["params"].items():
            grad = np.abs(want["trace"][k] - mom * old_trace[k]).max()
            np.testing.assert_allclose(
                g["trace"][k], want["trace"][k], rtol=0,
                atol=1e-4 * grad + 1e-12, err_msg=f"{what} trace {k}")
            np.testing.assert_allclose(
                g["params"][k], v, rtol=0,
                atol=1e-4 * float(jlr[i]) * (1 + mom) * grad
                + 2.4e-7 * np.abs(v).max(), err_msg=f"{what} param {k}")

    # The port's loop run freely is its step over the same batches
    free = _port_state(cfg, sched, params, stats)
    free = fit_multigrid(cfg, free, make_train_step(
        free.model, cfg.NETWORK.WEIGHT_DECAY), sched,
        lambda p: (_torch_batch(b) for b in data[p.index]), seed=0)
    manual = _port_state(cfg, sched, params, stats)
    step = make_train_step(manual.model, cfg.NETWORK.WEIGHT_DECAY)
    gen = torch.Generator().manual_seed(0)
    for p_index, j in jrec.order:
        manual, _ = step(manual, _torch_batch(data[p_index][j]), gen)
    a, b = (convert.train_state_to_flax(s) for s in (free, manual))
    assert a["step"] == b["step"] == total
    for part in ("params", "batch_stats"):
        for k, v in _leaves(b[part]).items():
            np.testing.assert_array_equal(_leaves(a[part])[k], v,
                                          err_msg=f"{part} {k}")
    for k, v in _leaves(b["opt_state"]["trace"]).items():
        np.testing.assert_array_equal(_leaves(a["opt_state"]["trace"])[k],
                                      v, err_msg=f"trace {k}")


# ------------------------------------------------------- the train tool

CONFIG = os.path.join(ROOT, "x3d_tpu_torch", "configs", "kinetics",
                      "X3D_XS.yaml")
# tests/test_multigrid.py's CLI config: base (2, 4, 32), phases (4, 2, 32)
# and (2, 4, 32); 4 base steps an epoch, 3 epochs: [0, 1, 1], 2 + 4 + 4
OPTS = ["--opts", "NETWORK.C1_CHANNELS", "4", "NETWORK.DEPTH_FACTOR",
        "0.34", "NETWORK.NUM_CLASSES", "5", "NETWORK.DROPOUT_RATE", "0.0",
        "DATA.TEMP_DURATION", "4", "DATA.TRAIN_CROP_SIZE", "32",
        "DATA.TRAIN_JITTER_SCALES", "[36,44]", "DATA.TEST_CROP_SIZE", "32",
        "TRAIN.BATCH_SIZE", "2", "TEST.NUM_TEMPORAL_VIEWS", "1",
        "TEST.NUM_SPATIAL_CROPS", "1", "TEST.BATCH_SIZE", "2",
        "MULTIGRID.SPATIAL_DIVISOR", "4",
        "MULTIGRID.LONG_CYCLE_FACTORS", "[[0.5,1.0],[1.0,1.0]]",
        "--device", "cpu"]


class _Keep(hooks.Hook):
    """Keeps the live state, each step's LR and each epoch's validation;
    raises after the step ``crash_at`` (after the checkpoint hook)."""

    def __init__(self, crash_at=None):
        self.state, self.lrs, self.val, self.crash_at = None, {}, [], crash_at

    def on_step_end(self, step, state):
        self.state = state
        self.lrs[step] = state.optimizer.param_groups[0]["lr"]
        if step == self.crash_at:
            raise KeyboardInterrupt(f"crash after step {step}")

    def on_epoch_end(self, epoch, state, train_metrics, val_metrics):
        self.val.append(val_metrics)


def _train(model_dir, *flags, keep=None):
    keep = keep or _Keep()
    rc = train_cli.main(
        [f"--config={CONFIG}", f"--model_dir={model_dir}", "--multigrid",
         "--steps_per_epoch=4", "--epochs=3", "--mixed_precision=false",
         *flags, *OPTS], extra_hooks=[keep])
    assert rc == 0
    return keep


@pytest.fixture
def recorded(monkeypatch):
    """The shape of every batch the train tool's synthetic iterators yield,
    in order."""
    import x3d_tpu_torch.data as data

    shapes = []
    make = data.synthetic_batches

    def recording(*args, **kw):
        for batch in make(*args, **kw):
            shapes.append(tuple(batch["video"].shape))
            yield batch

    monkeypatch.setattr(data, "synthetic_batches", recording)
    return shapes


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """An uninterrupted multigrid run of the tool, a save every 2 steps."""
    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("straight")
    return d, _train(d, "--synthetic", "--save_checkpoints_step=2")


def test_train_tool_walks_the_phases(tmp_path, recorded, caplog):
    with caplog.at_level(logging.INFO):
        keep = _train(tmp_path, "--synthetic")
    assert "multigrid long-cycle schedule:\nphase 0: 2x32^2 batch 4" \
        in caplog.text
    assert recorded == [(4, 2, 32, 32, 3)] * 2 + [(2, 4, 32, 32, 3)] * 8
    cfg = variant_config("XS")
    cfg.merge_from_list(OPTS[1:-2])
    sched = MultigridSchedule(cfg, 4, 3)
    assert keep.lrs == {s + 1: sched.make_lr_schedule()(s)
                        for s in range(10)}
    assert keep.lrs[1] == float(np.float32(lr_for_epoch(cfg, 0) * 2))
    assert keep.state.step == 10
    assert sorted(os.listdir(tmp_path / "checkpoints")) == [
        "ckpt-10.pt", "ckpt-2.pt", "ckpt-6.pt"]


def test_train_tool_multigrid_from_the_config(tmp_path, recorded):
    """MULTIGRID.ENABLE turns the mode on as --multigrid does."""
    rc = train_cli.main(
        [f"--config={CONFIG}", f"--model_dir={tmp_path}", "--synthetic",
         "--steps_per_epoch=4", "--epochs=1", "--mixed_precision=false",
         *OPTS[:-2], "MULTIGRID.ENABLE", "True", "--device", "cpu"])
    assert rc == 0
    # one epoch: the fine-tune tail, the base phase
    assert recorded == [(2, 4, 32, 32, 3)] * 4


def test_crash_and_resume_in_one_process(tmp_path, straight, caplog):
    """A hook raises after the step-4 checkpoint (inside phase 1's first
    epoch, steps 3-6); the same command resumes there and ends on the
    uninterrupted run's model and optimizer state, bit for bit."""
    with pytest.raises(KeyboardInterrupt):
        _train(tmp_path, "--synthetic", "--save_checkpoints_step=2",
               keep=_Keep(crash_at=4))
    assert sorted(os.listdir(tmp_path / "checkpoints")) == [
        "ckpt-2.pt", "ckpt-4.pt"]
    with caplog.at_level(logging.INFO):
        again = _train(tmp_path, "--synthetic", "--save_checkpoints_step=2")
    assert "resumed at global step 4 (epoch 1, step-in-epoch 2)" \
        in caplog.text
    assert sorted(again.lrs) == list(range(5, 11))
    _, keep = straight
    assert again.state.step == keep.state.step == 10
    for k, v in keep.state.model.state_dict().items():
        assert torch.equal(again.state.model.state_dict()[k], v), k
    want = keep.state.optimizer.state_dict()
    got = again.state.optimizer.state_dict()
    assert want["param_groups"] == got["param_groups"]
    for i, slots in want["state"].items():
        for name, v in slots.items():
            assert torch.equal(got["state"][i][name], v), (i, name)


def test_multigrid_refuses_native_loader(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        train_cli.main([f"--config={CONFIG}", f"--model_dir={tmp_path}",
                        "--synthetic", "--multigrid", "--native_loader",
                        "--device=cpu"])
    assert e.value.code == 2
    assert "--multigrid" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "checkpoints")


def _frames(n, base):
    y = np.arange(48)[:, None, None]
    x = np.arange(64)[None, :, None]
    return np.stack([np.broadcast_to((base * 40 + i * 5 + y + x) % 250,
                                     (48, 64, 3)).astype(np.uint8)
                     for i in range(n)])


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    """Six tiny videos (48x64, labels 0-4) in train shards and one val
    shard, written on the CPU by the port's writer."""
    from x3d_tpu_torch.data import write_video_array_shards

    d = tmp_path_factory.mktemp("shards")
    videos = [(_frames(12 + i, i), i % 5) for i in range(6)]
    write_video_array_shards(videos, str(d), prefix="train",
                             videos_per_record=2, device="cpu")
    write_video_array_shards(videos[:4], str(d), prefix="val",
                             videos_per_record=4, device="cpu")
    return d


def test_train_tool_multigrid_on_shards(tmp_path, shard_dir, monkeypatch):
    """Each phase's reader takes its phase's geometry; the val reader and
    the recalibration batches the base one; the statistics are
    recalibrated (2 base-shape batches) before each validation."""
    import x3d_tpu_torch.data as data

    made = []
    Reader = data.InputReader

    class Recording(Reader):
        def __call__(self, pattern, batch_size):
            g = self.cfg.DATA
            entry = {"training": self.is_training, "batch": batch_size,
                     "geometry": (g.TEMP_DURATION, g.TRAIN_CROP_SIZE,
                                  tuple(g.TRAIN_JITTER_SCALES)),
                     "shapes": []}
            made.append(entry)
            for out in super().__call__(pattern, batch_size):
                entry["shapes"].append(tuple(out["video"].shape))
                yield out

    monkeypatch.setattr(data, "InputReader", Recording)
    recal_calls = []
    import x3d_tpu_torch.train.multigrid as mg
    make_recal = mg.make_bn_recalibrator

    def counting(model, batches_fn, n, seed, momentum):
        fn = make_recal(model, batches_fn, n, seed, momentum)

        def recal(state):
            before = _stats(model)
            out = fn(state)
            recal_calls.append((n, before, _stats(model)))
            return out
        return recal

    monkeypatch.setattr(mg, "make_bn_recalibrator", counting)
    keep = _Keep()
    rc = train_cli.main(
        [f"--config={CONFIG}", f"--model_dir={tmp_path}", "--multigrid",
         "--use_tfrecord", f"--train_file_pattern={shard_dir / 'train-*'}",
         f"--val_file_pattern={shard_dir / 'val-*'}", "--steps_per_epoch=4",
         "--epochs=3", "--mixed_precision=false", *OPTS[:-2],
         "MULTIGRID.BN_RECALC_BATCHES", "2", "--device", "cpu"],
        extra_hooks=[keep])
    assert rc == 0
    train = [m for m in made if m["training"]]
    by_geometry = {}
    for m in train:
        by_geometry.setdefault((m["batch"], m["geometry"]), []).append(m)
    assert sorted(by_geometry) == [(2, (4, 32, (36, 44))),
                                   (4, (2, 32, (36, 44)))]
    (p0,) = by_geometry[(4, (2, 32, (36, 44)))]
    assert p0["shapes"] == [(4, 2, 32, 32, 3)] * 2
    base = by_geometry[(2, (4, 32, (36, 44)))]
    assert sorted(len(m["shapes"]) for m in base) == [6, 8]   # recal, phase
    assert all(s == (2, 4, 32, 32, 3) for m in base for s in m["shapes"])
    val = [m for m in made if not m["training"]]
    assert len(val) == 3 and all(m["batch"] == 2 for m in val)
    assert [v["count"] for v in keep.val] == [4.0, 4.0, 4.0]
    assert all(np.isfinite(v["loss"]) for v in keep.val)
    assert len(recal_calls) == 3 and all(n == 2 for n, _, _ in recal_calls)
    for _, before, after in recal_calls:
        means = [k for k in after if k.endswith((".mean", ".var"))]
        assert all(torch.isfinite(after[k]).all() for k in means)
        assert any(not torch.equal(before[k], after[k]) for k in means)
