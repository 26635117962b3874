"""The port's checkpoint manager: exact save / restore of a train state,
rotation, the empty-directory cases, the weights-only restore, and resume.

Everything here is exact (``torch.equal``): a checkpoint holds the tensors
themselves.  The resume test trains a tiny model (``C1_CHANNELS=4,
DEPTH_FACTOR=0.34``, T=4, 32² crops, float32 on the CPU) with dropout 0.5:
four straight steps equal two steps, a save, a restore into a freshly built
state and two more steps, bit for bit -- the dropout mask of step n comes
from (seed, n), not from a generator that would have to be saved.
"""

import os

import pytest
import torch

from x3d_tpu_torch import variant_config
from x3d_tpu_torch.data import synthetic_batches
from x3d_tpu_torch.models import create_model
from x3d_tpu_torch.train import create_train_state, make_train_step
from x3d_tpu_torch.train.checkpoint import CheckpointManager


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfg(optimizer="sgd"):
    cfg = variant_config("XS")
    cfg.NETWORK.C1_CHANNELS = 4
    cfg.NETWORK.DEPTH_FACTOR = 0.34
    cfg.NETWORK.NUM_CLASSES = 10
    cfg.NETWORK.DROPOUT_RATE = 0.5
    cfg.DATA.TEMP_DURATION = 4
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 32
    cfg.TRAIN.OPTIMIZER = optimizer
    return cfg


def _fresh(cfg, seed):
    model = create_model(cfg, dtype=torch.float32, device="cpu", seed=seed)
    return create_train_state(cfg, model, steps_per_epoch=2)


def _train(cfg, state, steps):
    step = make_train_step(state.model, cfg.NETWORK.WEIGHT_DECAY)
    batch = next(synthetic_batches(cfg, 2, dtype=torch.float32, device="cpu"))
    gen = torch.Generator().manual_seed(7)
    losses = []
    for _ in range(steps):
        state, metrics = step(state, batch, gen)
        losses.append(float(metrics["loss"]))
    return losses


def _slots(state):
    """The optimizer's per-parameter tensors, by parameter name."""
    return {(name, slot): value
            for name, p in state.model.named_parameters()
            for slot, value in state.optimizer.state.get(p, {}).items()
            if torch.is_tensor(value)}


def _assert_same_state(a, b):
    assert a.step == b.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = _slots(a), _slots(b)
    assert oa.keys() == ob.keys() and oa
    for k in oa:
        assert torch.equal(oa[k], ob[k]), k


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_save_restore_is_exact(tmp_path, optimizer):
    cfg = _cfg(optimizer)
    state = _fresh(cfg, seed=0)
    _train(cfg, state, 2)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, state)
    assert mgr.latest_epoch() == mgr.latest() == 2
    assert os.listdir(tmp_path) == ["ckpt-2.pt"]      # no temporary left

    other = _fresh(cfg, seed=1)
    restored, key = mgr.restore(other)
    assert restored is other and key == 2
    _assert_same_state(other, state)
    # the restored state owns its tensors: training it leaves the file's
    _train(cfg, other, 1)
    again, _ = mgr.restore(_fresh(cfg, seed=2))
    _assert_same_state(again, state)
    mgr.close()


def test_max_to_keep_and_explicit_key(tmp_path):
    cfg = _cfg()
    state = _fresh(cfg, seed=0)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for key in (3, 6, 9, 12):
        state.step = key
        mgr.save(key, state)
    assert mgr.keys() == [9, 12]
    _, key = mgr.restore(state, epoch=9)
    assert key == 9 and state.step == 9
    unbounded = CheckpointManager(str(tmp_path), max_to_keep=0)
    unbounded.save(15, state)
    assert unbounded.keys() == [9, 12, 15]


def test_empty_directory(tmp_path):
    cfg = _cfg()
    state = _fresh(cfg, seed=0)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    mgr = CheckpointManager(str(tmp_path / "new"))
    assert mgr.latest_epoch() is None
    restored, key = mgr.restore(state)
    assert restored is state and key == 0 and state.step == 0
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k])
    with pytest.raises(FileNotFoundError, match="No checkpoint"):
        mgr.restore_weights_only(state)
    with pytest.raises(FileNotFoundError, match="No checkpoint"):
        mgr.restore_weights_only(state, str(tmp_path / "elsewhere"))


def test_restore_weights_only_keeps_a_fresh_optimizer(tmp_path):
    cfg = _cfg()
    trained = _fresh(cfg, seed=0)
    _train(cfg, trained, 2)
    CheckpointManager(str(tmp_path / "pre")).save(2, trained)

    state = _fresh(cfg, seed=1)
    mgr = CheckpointManager(str(tmp_path / "run"))
    out = mgr.restore_weights_only(state, str(tmp_path / "pre"))
    assert out is state and state.step == 0
    assert not _slots(state)                       # no momentum carried over
    for k, v in trained.model.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k
    # an Adam run warm-starts from an SGD checkpoint: the slots are ignored
    adam = _fresh(_cfg("adam"), seed=2)
    mgr.restore_weights_only(adam, str(tmp_path / "pre"))
    assert torch.equal(adam.model.state_dict()["conv_1.conv_t.kernel"],
                       trained.model.state_dict()["conv_1.conv_t.kernel"])


def test_resume_continues_bit_for_bit(tmp_path):
    cfg = _cfg()
    straight = _fresh(cfg, seed=0)
    want = _train(cfg, straight, 4)

    first = _fresh(cfg, seed=0)
    got = _train(cfg, first, 2)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(first.step, first)
    resumed, key = CheckpointManager(str(tmp_path)).restore(
        _fresh(cfg, seed=3))
    assert key == 2 and resumed.step == 2
    got += _train(cfg, resumed, 2)
    assert got == want
    assert len(set(want)) == 4
    _assert_same_state(resumed, straight)
    # the schedule is a function of the step: epoch 1's rate after 2 steps
    assert resumed.schedule(resumed.step) == straight.schedule(4)
