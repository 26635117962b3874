"""The Flax <-> PyTorch weight bridge: a JAX-initialised tiny X3D's tree
converts to a state_dict that loads into the port with exactly its keys
and shapes, and converts back to the same tree, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x3d_tpu import get_default_config as jax_default_config
from x3d_tpu.models import create_model as jax_create_model
from x3d_tpu.models import init_variables
from x3d_tpu_torch import convert, get_default_config
from x3d_tpu_torch.models import create_model


def _tiny(cfg):
    cfg.NETWORK.C1_CHANNELS = 4
    cfg.NETWORK.DEPTH_FACTOR = 0.34
    return cfg


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_round_trip_is_exact():
    torch.set_num_threads(1)
    model = jax_create_model(_tiny(jax_default_config()), dtype=jnp.float32)
    variables = init_variables(model, jax.random.PRNGKey(0),
                               jnp.zeros((1, 5, 32, 32, 3)))
    sd = convert.flax_to_state_dict(variables)

    port = create_model(_tiny(get_default_config()), dtype=torch.float32,
                        device="cpu", init=False)
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    port.load_state_dict(sd, strict=True)

    back = convert.state_dict_to_flax(port.state_dict())
    for collection in ("params", "batch_stats"):
        got = dict(_leaves(back[collection]))
        ref = dict(_leaves(variables[collection]))
        assert got.keys() == ref.keys()
        for path, arr in ref.items():
            assert got[path].shape == arr.shape, path
            assert np.array_equal(got[path], arr), path


def test_layouts():
    """Each kind of kernel lands in the layout its port op reads."""
    rng = np.random.default_rng(0)
    conv = rng.normal(size=(1, 3, 3, 3, 8)).astype(np.float32)
    pw = rng.normal(size=(1, 1, 1, 8, 18)).astype(np.float32)
    dw = rng.normal(size=(3, 3, 3, 1, 18)).astype(np.float32)
    dense = rng.normal(size=(18, 32)).astype(np.float32)
    sd = convert.flax_to_state_dict({"params": {
        "conv_1": {"conv_s": {"kernel": conv}},
        "blk": {"a": {"kernel": pw}, "b": {"kernel": dw}},
        "fc_1": {"kernel": dense}}})
    assert np.array_equal(sd["conv_1.conv_s.weight"].numpy(),
                          conv.transpose(4, 3, 0, 1, 2))
    assert np.array_equal(sd["blk.a.weight"].numpy(), pw[0, 0, 0].T)
    assert np.array_equal(sd["blk.b.kernel"].numpy(), dw)
    assert np.array_equal(sd["fc_1.weight"].numpy(), dense.T)


# --------------------------------------------------- the train-state bridge
#
# A state trained in the port is written with ``train_state_to_flax`` into
# the JAX package's Orbax checkpoint directory, read back by the JAX
# package's own ``CheckpointManager`` and loaded into a fresh port state
# with ``train_state_from_flax``.  The bridge itself is exact (the arrays
# come back bit for bit); the next step's loss on the JAX side agrees with
# the port's within rtol 1e-5 (float32, sums in another order).

def _train_cfg(cfg, optimizer):
    _tiny(cfg)
    cfg.NETWORK.NUM_CLASSES = 10
    cfg.NETWORK.DROPOUT_RATE = 0.0
    cfg.DATA.TEMP_DURATION = 4
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 32
    cfg.TRAIN.DATASET_SIZE = 4
    cfg.TRAIN.BATCH_SIZE = 2
    cfg.TRAIN.OPTIMIZER = optimizer
    return cfg


def _fill_opt_state(opt_state, slots, step):
    """optax's state tuple with the bridge's slots put in: the SGD trace,
    Adam's moments and count, and the schedule's count."""
    as_jnp = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    filled = []
    for part in opt_state:
        if hasattr(part, "trace"):
            part = part._replace(trace=as_jnp(slots["trace"]))
        elif hasattr(part, "mu"):
            part = part._replace(
                count=jnp.asarray(slots["count"], part.count.dtype),
                mu=as_jnp(slots["mu"]), nu=as_jnp(slots["nu"]))
        elif hasattr(part, "count"):
            part = part._replace(count=jnp.asarray(step, part.count.dtype))
        filled.append(part)
    return tuple(filled)


def _read_opt_state(opt_state):
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)    # noqa: E731
    slots = {}
    for part in opt_state:
        if hasattr(part, "trace"):
            slots["trace"] = to_np(part.trace)
        elif hasattr(part, "mu"):
            slots.update(mu=to_np(part.mu), nu=to_np(part.nu),
                         count=int(part.count))
    return slots


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_train_state_crosses_through_the_jax_checkpoint(tmp_path, optimizer):
    from x3d_tpu import variant_config as jax_variant_config
    from x3d_tpu.train import create_train_state as jax_create_train_state
    from x3d_tpu.train import make_train_step as jax_make_train_step
    from x3d_tpu.train.checkpoint import CheckpointManager
    from x3d_tpu_torch import variant_config
    from x3d_tpu_torch.train import create_train_state, make_train_step

    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    video = rng.normal(size=(2, 4, 32, 32, 3)).astype(np.float32)
    label = np.array([3, 7])
    batch = {"video": torch.from_numpy(video),
             "label": torch.from_numpy(label)}

    def port_state(seed):
        cfg = _train_cfg(variant_config("XS"), optimizer)
        model = create_model(cfg, dtype=torch.float32, device="cpu",
                             seed=seed)
        return cfg, create_train_state(cfg, model)

    cfg, state = port_state(0)
    step = make_train_step(state.model, cfg.NETWORK.WEIGHT_DECAY)
    gen = torch.Generator().manual_seed(0)
    state, _ = step(state, batch, gen)                 # the slots exist now
    tree = convert.train_state_to_flax(state)
    assert tree["step"] == 1
    assert set(tree["opt_state"]) == ({"trace"} if optimizer == "sgd"
                                      else {"mu", "nu", "count"})

    # into the JAX package's state and through its checkpoint directory
    jcfg = _train_cfg(jax_variant_config("XS"), optimizer)
    jmodel = jax_create_model(jcfg, dtype=jnp.float32)
    template = jax_create_train_state(jcfg, jmodel, jax.random.PRNGKey(1),
                                      jnp.asarray(video))
    as_jnp = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    jstate = template.replace(
        step=jnp.asarray(tree["step"], template.step.dtype),
        params=as_jnp(tree["params"]),
        batch_stats=as_jnp(tree["batch_stats"]),
        opt_state=_fill_opt_state(template.opt_state, tree["opt_state"],
                                  tree["step"]))
    mgr = CheckpointManager(str(tmp_path / "checkpoints"))
    mgr.save(tree["step"], jstate)
    restored, key = mgr.restore(template)
    mgr.close()
    assert key == 1 and int(restored.step) == 1

    # back into a fresh port state: bit for bit what was written
    back = {"step": int(restored.step),
            "params": jax.tree_util.tree_map(np.asarray, restored.params),
            "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                  restored.batch_stats),
            "opt_state": _read_opt_state(restored.opt_state)}
    cfg2, state2 = port_state(5)
    convert.train_state_from_flax(back, state2)
    assert state2.step == 1
    for k, v in state.model.state_dict().items():
        assert torch.equal(state2.model.state_dict()[k], v), k
    for p, p2 in zip(state.model.parameters(), state2.model.parameters()):
        held, held2 = state.optimizer.state[p], state2.optimizer.state[p2]
        assert held.keys() == held2.keys()
        for slot in held:
            assert torch.equal(torch.as_tensor(held[slot]),
                               torch.as_tensor(held2[slot])), slot

    # both continue alike: the port's next step from either state, exactly;
    # the JAX package's next step from the restored checkpoint, rtol 1e-5
    _, m1 = step(state, batch, gen)
    step2 = make_train_step(state2.model, cfg2.NETWORK.WEIGHT_DECAY)
    _, m2 = step2(state2, batch, gen)
    assert float(m1["loss"]) == float(m2["loss"])
    jnew, jm = jax.jit(jax_make_train_step(
        jmodel, jcfg.NETWORK.WEIGHT_DECAY))(
            restored, {"video": jnp.asarray(video),
                       "label": jnp.asarray(label)}, jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(m2["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    # ... and land on the same parameters (the momentum crossed over)
    got = convert.state_dict_to_flax(state2.model.state_dict())["params"]
    lr = state2.schedule(1)
    got, want = dict(_leaves(got)), dict(_leaves(jnew.params))
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0,
                                   atol=2e-3 * lr + 1e-6 * np.abs(w).max(),
                                   err_msg=str(path))
