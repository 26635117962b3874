"""Data parallelism, per-replica (grouped) BatchNorm and the split head,
on the CPU, against the JAX package.

Tiny XS geometry as in ``tests/test_torch_train.py`` (``C1_CHANNELS=4,
DEPTH_FACTOR=0.34``, 10 classes, T=4, 32², dropout 0, float32), a global
train batch of 4 clips and an eval batch of 4 videos x 2 views; weights
from the port's seeded initialisation with random non-trivial BN
(``test_torch_train._randomize_bn``), carried to the JAX package by
``convert``.  The JAX model runs its default (unfused) composition, with
``bn_groups=2`` its ``GroupedBatchNorm``; the port runs its training path
through the kernels' plain versions.

Multi-rank runs are gloo process groups on the CPU, one process a rank
(``tests/torch_parallel_worker.py``, which imports nothing of JAX), meeting
by ``file://`` under a temporary directory; each group runs once for the
module and the leaf comparisons are parametrised over its result:

* ``sync_2``: 2 data ranks, ``SYNC_BN: True``, against JAX's one-device
  step on the global batch;
* ``grouped_2``: 2 data ranks, ``SYNC_BN: False``, against JAX
  ``bn_groups=2`` (and the one-process port with ``bn_groups=2``);
* ``head_2x2``: data 2 x model 2, the head split, against JAX and against
  ``data_4`` (4 data ranks x model 1, itself against JAX);
* ``sync_2_convs``: ``sync_2`` with remat "convs" (the synced BN's
  all-reduce runs again in each block's recompute), against JAX and bit for
  bit against ``sync_2``;
* each group's eval sums (every rank evaluates its share of the videos
  before the step) against JAX's eval step on the whole batch.

Tolerances are ``test_torch_train``'s: loss rtol 1e-6; each gradient within
1e-4 of its leaf's largest |gradient|; the running statistics within 1e-6
of their leaf's largest value; the updated parameters within 1e-4 · lr of
the gradient's leaf scale plus two float32 ulps.  The eval counts and hits
exactly, the loss sum rtol 1e-6.  Every rank of a group ends with the same
parameters and statistics, bit for bit.  The bfloat16 grouped step is held
to ``tests/test_torch_bf16.py``'s rule (within 2 e_jax of JAX's float32 and
bfloat16 results).
"""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_bf16 as tb
import test_torch_train as tt
import torch_parallel_worker as worker
from x3d_tpu import variant_config as jax_variant_config
from x3d_tpu.models import create_model as jax_create_model
from x3d_tpu.train import create_train_state as jax_create_train_state
from x3d_tpu.train import l2_penalty as jax_l2_penalty
from x3d_tpu.train import make_eval_step as jax_make_eval_step
from x3d_tpu.train import make_train_step as jax_make_train_step
from x3d_tpu_torch import convert, parallel
from x3d_tpu_torch.data import InputReader
from x3d_tpu_torch.models import create_model
from x3d_tpu_torch.models import x3d as port_x3d
from x3d_tpu_torch.train import (create_train_state, make_bn_recalibrator,
                                 make_lr_schedule, make_train_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
B, VIDEOS, VIEWS = 4, 4, 2
RUN_TIMEOUT = 300
# name: (world, data, model, SYNC_BN, the JAX bn_groups it equals)
RUNS = {"sync_2": (2, 2, 1, True, 1),
        "grouped_2": (2, 2, 1, False, 2),
        "head_2x2": (4, 2, 2, True, 1),
        "data_4": (4, 4, 1, True, 1),
        "sync_2_convs": (2, 2, 1, True, 1)}
# the runs with remat (the others: none, as the tiny config resolves it)
REMAT = {"sync_2_convs": "convs"}
KINDS = ("loss", "grads", "params", "stats")


def _jcfg():
    cfg = tt._tiny(jax_variant_config("XS"))
    cfg.TEST.NUM_TEMPORAL_VIEWS = VIEWS
    cfg.TRAIN.BATCH_SIZE = B
    return cfg


@pytest.fixture(scope="module")
def data():
    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    model = create_model(worker.tiny_cfg(), dtype=torch.float32,
                         device="cpu", seed=0)
    variables = convert.state_dict_to_flax(
        {k: v.detach() for k, v in model.state_dict().items()})
    params, stats = tt._randomize_bn(variables["params"],
                                     variables["batch_stats"], rng)
    return dict(
        params=params, stats=stats,
        x=rng.normal(size=(B, tt.T, tt.S, tt.S, 3)).astype(np.float32),
        label=np.array([3, 7, 1, 3]),
        ex=rng.normal(size=(VIDEOS * VIEWS, tt.T, tt.S, tt.S, 3))
        .astype(np.float32),
        elabel=np.array([2, 5, 5, 9]))


def _jax_step(d, groups, dtype=jnp.float32):
    """JAX's step on the global batch: loss, gradients, updated parameters
    and running statistics (leaves), and its eval sums on the eval batch
    from the state before the step."""
    cfg = _jcfg()
    model = jax_create_model(cfg, dtype=dtype, bn_groups=groups)
    batch = {"video": jnp.asarray(d["x"]), "label": jnp.asarray(d["label"])}
    params = jax.tree_util.tree_map(jnp.asarray, d["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, d["stats"])
    wd = cfg.NETWORK.WEIGHT_DECAY

    def loss_fn(p):
        logits, _ = model.apply(
            {"params": p, "batch_stats": stats}, batch["video"], train=True,
            return_logits=True, rngs={"dropout": jax.random.PRNGKey(1)},
            mutable=["batch_stats"])
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), batch["label"]).mean()
        return ce + wd * jax_l2_penalty(p), logits

    (loss, logits), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    state = jax_create_train_state(cfg, model, jax.random.PRNGKey(0),
                                   batch["video"])
    state = state.replace(params=params, batch_stats=stats,
                          opt_state=state.tx.init(params))
    sums = jax.jit(jax_make_eval_step(model))(
        state, {"video": jnp.asarray(d["ex"]),
                "label": jnp.asarray(d["elabel"])})
    new, _ = jax.jit(jax_make_train_step(model, wd))(
        state, batch, jax.random.PRNGKey(0))
    return dict(loss=float(loss), logits=np.asarray(logits, np.float32),
                grads=tt._leaves(grads), params=tt._leaves(new.params),
                stats=tt._leaves(new.batch_stats),
                eval={k: float(v) for k, v in sums.items()})


@pytest.fixture(scope="module")
def ref(data):
    cache = {}

    def get(groups):
        if groups not in cache:
            cache[groups] = _jax_step(data, groups)
        return cache[groups]
    return get


def _port_result(loss, grads, state):
    tree = convert.state_dict_to_flax(state)
    return dict(loss=loss,
                grads=tt._leaves(convert.state_dict_to_flax(grads)["params"]),
                params=tt._leaves(tree["params"]),
                stats=tt._leaves(tree["batch_stats"]))


def _lr():
    cfg = worker.tiny_cfg()
    return make_lr_schedule(
        cfg, cfg.TRAIN.DATASET_SIZE // cfg.TRAIN.BATCH_SIZE)(0)


def _compare(got, want, kind, what):
    if kind == "loss":
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6,
                                   err_msg=what)
    elif kind == "grads":
        tt._assert_leaves(got["grads"], want["grads"], 1e-4, f"{what} grad")
    elif kind == "stats":
        tt._assert_leaves(got["stats"], want["stats"], 1e-6,
                          f"{what} running statistic")
    else:
        lr = _lr()
        assert sorted(got["params"]) == sorted(want["params"])
        for k, w in want["params"].items():
            np.testing.assert_allclose(
                got["params"][k], w, rtol=0,
                atol=1e-4 * lr * np.abs(want["grads"][k]).max()
                + 2.4e-7 * np.abs(w).max(), err_msg=f"{what} {k}")


# ------------------------------------------------------------ one process


@pytest.fixture(scope="module")
def grouped_one_process(data):
    cfg = worker.tiny_cfg(sync_bn=False)
    model = create_model(cfg, dtype=torch.float32, device="cpu", init=False,
                         bn_groups=2)
    model.load_state_dict(convert.flax_to_state_dict(
        {"params": data["params"], "batch_stats": data["stats"]}))
    state = create_train_state(cfg, model)
    step = make_train_step(model, cfg.NETWORK.WEIGHT_DECAY)
    state, metrics = step(state, {"video": torch.from_numpy(data["x"]),
                                  "label": torch.from_numpy(data["label"])},
                          torch.Generator().manual_seed(0))
    return _port_result(
        float(metrics["loss"]),
        {n: p.grad for n, p in model.named_parameters()},
        model.state_dict())


@pytest.mark.parametrize("kind", KINDS)
def test_grouped_bn_one_process_matches_jax(grouped_one_process, ref, kind):
    _compare(grouped_one_process, ref(2), kind, "bn_groups=2")


@pytest.mark.parametrize("where", ["stats", "sums", "columns", "affine",
                                   "step"])
def test_grouped_bn_batch_must_divide(where):
    """As the JAX package's GroupedBatchNorm, a batch that the groups do
    not divide raises a ValueError naming them."""
    x = torch.randn(4, 2, 3, 3, 8)
    match = "not divisible by 3 BN groups"
    with pytest.raises(ValueError, match=match):
        if where == "stats":
            port_x3d.moments(x, 3)
        elif where == "sums":
            port_x3d.moments_from_sums(torch.ones(8, 4), torch.ones(8, 4),
                                       72, 3)
        elif where == "columns":
            port_x3d.columns(torch.ones(3, 8), 4)
        elif where == "affine":
            port_x3d.grouped_affine(x, torch.ones(3, 8), torch.ones(3, 8),
                                    torch.float32)
        else:
            cfg = worker.tiny_cfg()
            model = create_model(cfg, dtype=torch.float32, device="cpu",
                                 bn_groups=3)
            step = make_train_step(model, 0.0)
            step(create_train_state(cfg, model),
                 {"video": torch.randn(4, 4, 32, 32, 3),
                  "label": torch.zeros(4, dtype=torch.int64)},
                 torch.Generator().manual_seed(0))


def test_grouped_bn_eval_is_ungrouped():
    """Eval mode normalises with the running statistics whatever the
    groups: the same logits as the ungrouped model, bit for bit."""
    cfg = worker.tiny_cfg()
    x = torch.randn(2, 4, 32, 32, 3, generator=torch.Generator()
                    .manual_seed(1))
    out = []
    for g in (1, 2):
        model = create_model(cfg, dtype=torch.float32, device="cpu", seed=3,
                             bn_groups=g)
        with torch.no_grad():
            out.append(model(x, return_logits=True))
    assert torch.equal(out[0], out[1])


# ------------------------------------------------------------ bfloat16


@pytest.fixture(scope="module")
def bf16_grouped():
    """One grouped step (bn_groups=2) on both sides in float32 and bf16, at
    ``tests/test_torch_bf16.py``'s training geometry (T 4, 96², batch 8):
    (logits, gradients, update, running-statistics change), flattened."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    variables = tb._weights(tb._train_cfg(worker.tiny_cfg()), 0)
    params, stats = tt._randomize_bn(variables["params"],
                                     variables["batch_stats"], rng)
    x = rng.normal(size=(tb.TB, tt.T, tb.TS, tb.TS, 3)).astype(np.float32)
    label = rng.integers(0, tt.CLASSES, tb.TB)
    wd = tb._train_cfg(jax_variant_config("XS")).NETWORK.WEIGHT_DECAY
    out = {}
    for jdt, tdt, name in ((jnp.float32, torch.float32, "f32"),
                           (jnp.bfloat16, torch.bfloat16, "bf16")):
        out["jax", name] = _jax_grouped_bf16(jdt, params, stats, x, label,
                                             wd)
        out["port", name] = _port_grouped_bf16(tdt, params, stats, x, label,
                                               wd)
    return out


def _jax_grouped_bf16(dtype, params, stats, x, label, wd):
    cfg = tb._train_cfg(jax_variant_config("XS"))
    model = jax_create_model(cfg, dtype=dtype, bn_groups=2)
    batch = {"video": jnp.asarray(x), "label": jnp.asarray(label)}
    p = jax.tree_util.tree_map(jnp.asarray, params)
    s = jax.tree_util.tree_map(jnp.asarray, stats)

    def loss_fn(p_):
        logits, _ = model.apply(
            {"params": p_, "batch_stats": s}, batch["video"], train=True,
            return_logits=True, rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["batch_stats"])
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), batch["label"]).mean()
        return ce + wd * jax_l2_penalty(p_), logits

    (_, logits), grads = jax.jit(jax.value_and_grad(loss_fn,
                                                    has_aux=True))(p)
    state = jax_create_train_state(cfg, model, jax.random.PRNGKey(0),
                                   batch["video"][:1])
    state = state.replace(params=p, batch_stats=s,
                          opt_state=state.tx.init(p))
    new, _ = jax.jit(jax_make_train_step(model, wd))(
        state, batch, jax.random.PRNGKey(0))
    delta = lambda a, b: jax.tree_util.tree_map(  # noqa: E731
        lambda u, v: np.asarray(u, np.float64) - np.asarray(v, np.float64),
        a, b)
    return (np.asarray(logits, np.float32).ravel(), tb._flat(grads),
            tb._flat(delta(new.params, p)),
            tb._flat(delta(new.batch_stats, s)))


def _port_grouped_bf16(dtype, params, stats, x, label, wd):
    cfg = tb._train_cfg(worker.tiny_cfg())
    model = create_model(cfg, dtype=dtype, device="cpu", init=False,
                         bn_groups=2)
    model.load_state_dict(convert.flax_to_state_dict(
        {"params": params, "batch_stats": stats}))
    seen = {}
    model.fc_2.register_forward_hook(
        lambda m, i, o: seen.__setitem__("logits", o.detach()))

    def trees():
        tree = convert.state_dict_to_flax(
            {k: v.detach().double() for k, v in model.state_dict().items()})
        return tb._flat(tree["params"]), tb._flat(tree["batch_stats"])

    p0, s0 = trees()
    step = make_train_step(model, wd)
    step(create_train_state(cfg, model),
         {"video": torch.from_numpy(x), "label": torch.from_numpy(label)},
         torch.Generator().manual_seed(0))
    p1, s1 = trees()
    grads = convert.state_dict_to_flax(
        {n: p.grad for n, p in model.named_parameters()})["params"]
    return (seen["logits"].float().numpy().ravel(), tb._flat(grads),
            p1 - p0, s1 - s0)


@pytest.mark.parametrize("what,index,measure", tb.TRAIN_CHECKS,
                         ids=[c[0] for c in tb.TRAIN_CHECKS])
def test_bf16_grouped_step_matches_jax(bf16_grouped, what, index, measure):
    r = bf16_grouped
    tb._check(f"grouped {what}", measure,
              *(r[side, dt][index] for side, dt in (
                  ("jax", "f32"), ("jax", "bf16"), ("port", "f32"),
                  ("port", "bf16"))))


# ------------------------------------------------------------ gloo ranks


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    return env


def _start(d, spec):
    """Start ``spec['world']`` worker processes; their handles."""
    os.makedirs(d, exist_ok=True)
    spec = {**spec, "init": "file://" + os.path.join(d, "rendezvous"),
            "out": d}
    path = os.path.join(d, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return [subprocess.Popen([sys.executable, WORKER, path, str(r)],
                             cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(spec["world"])]


def _join(d, procs):
    """Wait for every rank (killing all where one fails or the time runs
    out); every rank's output file."""
    deadline = time.monotonic() + RUN_TIMEOUT
    while any(p.poll() is None for p in procs):
        failed = [p for p in procs if p.poll() not in (None, 0)]
        if failed or time.monotonic() > deadline:
            for p in procs:
                p.kill()
            logs = "\n".join(p.communicate()[0][-3000:] for p in procs)
            pytest.fail(f"a rank failed or timed out:\n{logs}")
        time.sleep(0.1)
    logs = [p.communicate()[0] for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, logs[r][-3000:]
    return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=True)
            for r in range(len(procs))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, data):
    """Every group of RUNS, started together and run once: name -> the
    ranks' outputs."""
    base = tmp_path_factory.mktemp("gloo")
    inputs = os.path.join(base, "inputs.pt")
    torch.save({"state": convert.flax_to_state_dict(
                    {"params": data["params"], "batch_stats": data["stats"]}),
                "video": torch.from_numpy(data["x"]),
                "label": torch.from_numpy(data["label"]),
                "eval_video": torch.from_numpy(data["ex"]),
                "eval_label": torch.from_numpy(data["elabel"]),
                "views": VIEWS}, inputs)
    started = {}
    for name, (world, dp, mp, sync, _) in RUNS.items():
        started[name] = _start(os.path.join(base, name), {
            "mode": "step", "world": world, "data": dp, "model": mp,
            "sync_bn": sync, "inputs": inputs, "remat": REMAT.get(name)})
    return {name: _join(os.path.join(base, name), procs)
            for name, procs in started.items()}


def _rank_result(out):
    return _port_result(out["loss"], out["grads"], out["state"])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", list(RUNS))
def test_ranks_match_jax_global_step(runs, ref, name, kind):
    """W data ranks (with a split head where the mesh has a model axis)
    take JAX's step on the global batch: global BN statistics with
    SYNC_BN, one group a rank (JAX bn_groups=2) without."""
    out = runs[name][0]
    assert out["step"] == 1
    _compare(_rank_result(out), ref(RUNS[name][4]), kind, name)


@pytest.mark.parametrize("kind", KINDS)
def test_grouped_ranks_match_grouped_one_process(runs, grouped_one_process,
                                                 kind):
    _compare(_rank_result(runs["grouped_2"][0]), grouped_one_process, kind,
             "grouped_2 vs one process")


@pytest.mark.parametrize("kind", KINDS)
def test_head_split_matches_data_only(runs, kind):
    """Data 2 x model 2 (fc_1 by columns, fc_2 by rows) against 4 data
    ranks: the same loss, gradients, update and statistics."""
    _compare(_rank_result(runs["head_2x2"][0]),
             _rank_result(runs["data_4"][0]), kind, "2x2 vs 4x1")


def test_convs_ranks_equal_the_ranks_without_remat(runs):
    """Two synced ranks under remat "convs" take the step of two synced
    ranks without remat, bit for bit on every rank."""
    for got, want in zip(runs["sync_2_convs"], runs["sync_2"]):
        assert got["loss"] == want["loss"]
        assert got["metrics"] == want["metrics"]
        for kind in ("grads", "state"):
            assert sorted(got[kind]) == sorted(want[kind])
            for k, v in want[kind].items():
                assert torch.equal(got[kind][k], v), f"{kind} {k}"


def test_train_step_spans_name_the_reduce_on_a_mesh(runs):
    """On two data ranks the step records ``train.reduce`` between the
    backward pass and the optimizer, inside ``train.step``: the spans the
    loop's ``ProfileHook`` writes beside its trace."""
    for out in runs["sync_2"]:
        assert out["spans"] == [
            ["train.step", True], ["train.forward", False],
            ["train.backward", False], ["train.reduce", False],
            ["train.optimizer", False]]


def test_profile_hook_summary_reads_the_reduce(runs):
    """The profile hook's summary gives each rank's host ms a step by span,
    the all-reduce's among them."""
    for out in runs["sync_2"]:
        assert out["span_host"] == sorted([
            "train.step", "train.forward", "train.backward", "train.reduce",
            "train.optimizer"])


@pytest.mark.parametrize("name", list(RUNS))
def test_ranks_end_bit_identical(runs, name):
    outs = runs[name]
    first = outs[0]["state"]
    for r, out in enumerate(outs[1:], start=1):
        assert sorted(out["state"]) == sorted(first)
        for k, v in first.items():
            assert torch.equal(out["state"][k], v), f"rank {r} {k}"
        assert out["metrics"] == outs[0]["metrics"], r
    assert [o["mesh"] for o in outs] == [
        [r // RUNS[name][2], r % RUNS[name][2]] for r in range(len(outs))]


@pytest.mark.parametrize("name", list(RUNS))
def test_precise_bn_matches_one_process(runs, data, name):
    """Precise BN (``make_bn_recalibrator``, one batch) on each rank's
    share of the batch: with SYNC_BN the global batch's statistics, without
    it the mean of the ranks' -- the one-process recalibration on the whole
    batch with the same number of BN groups, within
    ``test_torch_multigrid``'s 1e-5 of the larger of each leaf's largest
    value before and after (the inversion (new - m old) / (1 - m) scales
    the running update's rounding by 10)."""
    groups = RUNS[name][4]
    cfg = worker.tiny_cfg(sync_bn=groups == 1)
    model = create_model(cfg, dtype=torch.float32, device="cpu", init=False,
                         bn_groups=groups)
    model.load_state_dict(convert.flax_to_state_dict(
        {"params": data["params"], "batch_stats": data["stats"]}))
    batch = {"video": torch.from_numpy(data["x"]),
             "label": torch.from_numpy(data["label"])}
    make_bn_recalibrator(model, lambda: [batch], 1, 0,
                         cfg.NETWORK.BN.MOMENTUM)(
        create_train_state(cfg, model))
    want = model.state_dict()
    old = convert.flax_to_state_dict(
        {"params": data["params"], "batch_stats": data["stats"]})
    for out in runs[name]:
        assert sorted(out["recal"]) == sorted(
            k for k in want if k.endswith((".mean", ".var")))
        for k, got in out["recal"].items():
            w = want[k]
            assert not torch.equal(w, old[k]), k
            scale = max(w.abs().max(), old[k].abs().max())
            assert (got - w).abs().max() <= 1e-5 * scale, k


@pytest.mark.parametrize("name", list(RUNS))
def test_checkpoint_holds_full_tensors_and_restores(runs, name):
    """Rank 0 writes one checkpoint of full tensors (parameters and SGD
    momentum: the step's first momentum is its gradient); every rank
    restores its shards, slots and step from it."""
    outs = runs[name]
    assert all(o["restored_equal"] for o in outs)
    d = os.path.join(outs[0]["out_dir"], "checkpoints")
    assert sorted(os.listdir(d)) == ["ckpt-1.pt"]
    ckpt = torch.load(os.path.join(d, "ckpt-1.pt"), weights_only=True)
    for k, v in outs[0]["state"].items():
        assert torch.equal(ckpt["model"][k], v), k
    names = [n for n, _ in create_model(worker.tiny_cfg(), device="cpu",
                                        init=False).named_parameters()]
    slots = ckpt["optimizer"]["state"]
    assert len(slots) == len(names)
    for i, n in enumerate(names):
        g = outs[0]["grads"][n]
        assert slots[i]["momentum_buffer"].shape == g.shape, n
        torch.testing.assert_close(slots[i]["momentum_buffer"], g, rtol=0,
                                   atol=0, msg=n)


@pytest.mark.parametrize("key", ["count", "loss_sum", "acc_sum",
                                 "top_5_sum"])
@pytest.mark.parametrize("name", ["sync_2", "head_2x2"])
def test_eval_sums_match_jax(runs, ref, name, key):
    """Each data rank evaluates its videos (their views clip-major); the
    four sums are added over the data group once, at the end."""
    want = ref(1)["eval"]
    for out in runs[name]:
        got = out["eval"]
        n = got["count"]
        assert n == VIDEOS
        if key == "count":
            assert n == want["count"]
        elif key == "loss_sum":
            np.testing.assert_allclose(got["loss"] * n, want["loss_sum"],
                                       rtol=1e-6)
        else:
            mean = "acc" if key == "acc_sum" else "top_5_acc"
            assert got[mean] * n == want[key]


# ------------------------------------------------------------ the tool


_TOOL_OPTS = ["--opts", "NETWORK.C1_CHANNELS", "4", "NETWORK.DEPTH_FACTOR",
              "0.34", "DATA.TEMP_DURATION", "4", "DATA.TRAIN_CROP_SIZE",
              "32", "DATA.TEST_CROP_SIZE", "32", "TRAIN.BATCH_SIZE", "4",
              "TEST.BATCH_SIZE", "2", "TEST.NUM_TEMPORAL_VIEWS", "2",
              "TPU.SYNC_BN", "False"]


def _tool_spec(model_dir, epochs):
    return {"mode": "tool", "world": 2, "argv": [
        "--config=" + os.path.join(ROOT, "x3d_tpu_torch", "configs",
                                   "kinetics", "X3D_S.yaml"),
        "--synthetic", f"--model_dir={model_dir}", "--steps_per_epoch=2",
        f"--epochs={epochs}", "--mixed_precision=false", "--num_gpus=2",
        "--device=cpu", *_TOOL_OPTS]}


@pytest.fixture(scope="module")
def tool_runs(tmp_path_factory):
    """tools/train on two gloo ranks: two epochs uninterrupted, and one
    epoch then a resumed second in another model folder."""
    base = tmp_path_factory.mktemp("tool")
    whole, cut = os.path.join(base, "whole"), os.path.join(base, "cut")
    eval_argv = ["--cfg=" + os.path.join(ROOT, "x3d_tpu_torch", "configs",
                                         "kinetics", "X3D_S.yaml"),
                 f"--model_folder={whole}", "--synthetic", "--max_batches=2",
                 "--gpus=2", "--device=cpu", *_TOOL_OPTS]
    started = [(os.path.join(base, "run_whole"),
                _start(os.path.join(base, "run_whole"),
                       {**_tool_spec(whole, 2), "eval_argv": eval_argv})),
               (os.path.join(base, "run_first"),
                _start(os.path.join(base, "run_first"),
                       _tool_spec(cut, 1)))]
    out = [_join(d, procs) for d, procs in started]
    files = sorted(os.listdir(os.path.join(cut, "checkpoints")))
    d = os.path.join(base, "run_resume")
    out.append(_join(d, _start(d, _tool_spec(cut, 2))))
    return {"whole": out[0], "first": out[1], "resume": out[2],
            "files_after_first": files}


def test_tool_checkpoint_written_by_rank_0_only(tool_runs):
    assert tool_runs["files_after_first"] == ["ckpt-2.pt"]
    for run in ("whole", "first", "resume"):
        rank0, rank1 = tool_runs[run]
        assert rank0["rc"] == rank1["rc"] == 0
        assert rank1["writes"] == [], run
        assert len(rank0["writes"]) == {"whole": 2, "first": 1,
                                        "resume": 1}[run], rank0["writes"]


@pytest.mark.parametrize("rank", [0, 1])
def test_tool_resume_equals_uninterrupted_run(tool_runs, rank):
    """Both ranks resume from rank 0's checkpoint at step 2 and end where
    the uninterrupted run ends, bit for bit (parameters, statistics,
    optimizer slots and the last step's loss)."""
    got, want = tool_runs["resume"][rank], tool_runs["whole"][rank]
    assert got["step"] == want["step"] == 4
    assert got["losses"][-1] == want["losses"][-1]
    for k, v in want["state"].items():
        assert torch.equal(got["state"][k], v), k
    for i, slots in want["optimizer"]["state"].items():
        for k, v in slots.items():
            assert torch.equal(got["optimizer"]["state"][i][k], v), (i, k)


def test_tool_eval_on_two_ranks(tool_runs):
    """tools/eval --gpus=2 on the trained folder: each rank evaluates 2
    batches of TEST.BATCH_SIZE // 2 = 1 video (2 views); rank 0 prints the
    sums over both ranks, rank 1 prints nothing."""
    rank0, rank1 = tool_runs["whole"]
    assert rank1["eval_stdout"] == ""
    lines = rank0["eval_stdout"].strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert got["count"] == 4.0
    assert sorted(got) == ["acc", "count", "loss", "top_5_acc"]
    assert np.isfinite(got["loss"])


# ------------------------------------------------------------ the mesh


def test_layout_raises_naming_both_numbers():
    assert parallel.layout(8) == (8, 1)
    assert parallel.layout(8, -1, 2) == (4, 2)
    assert parallel.layout(4, 2, 2) == (2, 2)
    with pytest.raises(ValueError, match="data=3 x model=2 needs 6"):
        parallel.layout(4, 3, 2)
    with pytest.raises(ValueError, match="not divisible by model=3"):
        parallel.layout(4, -1, 3)


def test_shard_batch_takes_contiguous_clip_major_slices():
    video = torch.arange(8 * 2).reshape(8, 2)
    label = torch.arange(4)
    got = []
    for r in range(2):
        mesh = parallel.Mesh(2, 2, r * 2 + 1, torch.device("cpu"))
        got.append(parallel.shard_batch({"video": video, "label": label},
                                        mesh, clips_per_sample=2))
    assert torch.equal(got[0]["label"], torch.tensor([0, 1]))
    assert torch.equal(got[1]["label"], torch.tensor([2, 3]))
    assert torch.equal(got[0]["video"], video[:4])
    assert torch.equal(got[1]["video"], video[4:])
    with pytest.raises(ValueError, match="not divisible by 3 data ranks"):
        parallel.local_batch(4, parallel.Mesh(3, 1, 0, torch.device("cpu")))
    assert parallel.local_batch(32, parallel.Mesh(4, 2, 0,
                                                  torch.device("cpu"))) == 8


@pytest.mark.parametrize("is_training", [True, False],
                         ids=["train", "eval"])
def test_input_reader_shards_files_between_hosts(tmp_path, is_training):
    """4 shards over 2 hosts: disjoint halves whose union is every file,
    the same split on every call (training shuffles alike on every host
    first, evaluation keeps the sorted order)."""
    for i in range(4):
        (tmp_path / f"train-{i:05d}-of-00004").write_bytes(b"")
    cfg = worker.tiny_cfg()
    pattern = str(tmp_path / "train-*")
    split = [InputReader(cfg, is_training, seed=5, device="cpu", host_id=h,
                         host_count=2).files(pattern) for h in (0, 1)]
    again = [InputReader(cfg, is_training, seed=5, device="cpu", host_id=h,
                         host_count=2).files(pattern) for h in (0, 1)]
    assert split == again
    assert [len(s) for s in split] == [2, 2]
    assert not set(split[0]) & set(split[1])
    assert sorted(split[0] + split[1]) == sorted(
        str(p) for p in tmp_path.iterdir())
    if not is_training:
        assert split[0] == sorted(split[0])
    with pytest.raises(ValueError, match="host 2 of 2"):
        InputReader(cfg, is_training, device="cpu", host_id=2, host_count=2)


def test_dryrun_multigpu_two_ranks(monkeypatch, capsys):
    """``tools/dryrun.dryrun_multigpu(2)``: X3D-M's train, eval, grouped
    and multigrid coarse steps on two gloo ranks, one OK line."""
    from x3d_tpu_torch.tools import dryrun

    monkeypatch.delenv("PYTHONPATH", raising=False)
    dryrun.dryrun_multigpu(2)
    out = capsys.readouterr().out
    assert "dryrun_multigpu OK" in out
    assert "'data': 2, 'model': 1" in out
