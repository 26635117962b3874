"""The reference against the program's plain path at tiny sizes, and the
yardstick's operations against ``FlopCounterMode`` on the reference.

These tests import both sides; the reference itself imports neither the
program nor JAX (``test_reference_imports_nothing_of_the_program``).
"""

from __future__ import annotations

import ast
import glob
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import weights, work
from benchmark.reference import train as rtrain
from benchmark.reference import x3d
from benchmark.tests.conftest import ROOT, TINY_NETWORK


def _port(network, state):
    from x3d_tpu_torch.config import get_default_config
    from x3d_tpu_torch.models import create_model

    cfg = get_default_config()
    cfg.merge_from_other_cfg({"NETWORK": network,
                              "TEST": {"NUM_TEMPORAL_VIEWS": 2,
                                       "NUM_SPATIAL_CROPS": 1}})
    model = create_model(cfg, dtype=torch.float32, device="cpu", init=False)
    model.load_state_dict(state)
    return cfg, model


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_eval_matches_the_plain_path(seed):
    state = weights.make(TINY_NETWORK, seed, "cpu")
    _, port = _port(TINY_NETWORK, state)
    ref = x3d.build(TINY_NETWORK, state, "cpu").eval()
    video = torch.randn(4, 4, 32, 32, 3,
                        generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        got = port(video)
        want = ref.probabilities(video, 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)


def test_three_train_steps_match_the_plain_path():
    from x3d_tpu_torch.train import create_train_state
    from x3d_tpu_torch.train.steps import make_train_step

    state = weights.make(TINY_NETWORK, 3, "cpu")
    cfg, port = _port(TINY_NETWORK, state)
    ref = x3d.build(TINY_NETWORK, state, "cpu")
    gen = torch.Generator().manual_seed(9)
    batches = [{"video": torch.randn(4, 4, 32, 32, 3, generator=gen),
                "label": torch.randint(0, 400, (4,), generator=gen)}
               for _ in range(3)]
    ts = create_train_state(cfg, port)
    step = make_train_step(port, cfg.NETWORK.WEIGHT_DECAY)
    dropout = torch.Generator().manual_seed(77)
    losses = []
    for b in batches:
        ts, m = step(ts, b, dropout)
        losses.append(float(m["loss"]))
    spe = max(1, cfg.TRAIN.DATASET_SIZE // cfg.TRAIN.BATCH_SIZE)
    keeps = [rtrain.dropout_keep(77, i, 1, 4, 0.5, "cpu") for i in range(3)]
    lrs = [rtrain.lr_at(dict(cfg.TRAIN), i, spe) for i in range(3)]
    assert lrs == [ts.schedule(i) for i in range(3)]
    out = rtrain.run_steps(ref, batches, keeps, lrs, cfg.TRAIN.MOMENTUM,
                           cfg.NETWORK.WEIGHT_DECAY)
    assert losses == pytest.approx(out["losses"], rel=1e-6)
    # float32 on both sides, summed in other orders: each leaf within 1e-4
    # of its norm
    got, want = port.state_dict(), ref.state_dict()
    for k in want:
        assert (got[k] - want[k]).norm() <= 1e-4 * want[k].norm(), k


@pytest.mark.parametrize("network,frames,size", [
    (TINY_NETWORK, 4, 32),
    ({**TINY_NETWORK, "C1_CHANNELS": 12, "DEPTH_FACTOR": 2.2}, 2, 64),
    ({**TINY_NETWORK, "C1_CHANNELS": 12, "DEPTH_FACTOR": 5.0}, 1, 78)])
def test_operations_match_the_flop_counter(network, frames, size):
    with torch.device("meta"):
        model = x3d.X3D(x3d.plan(network)).eval()
        video = torch.empty(3, frames, size, size, 3)
        with FlopCounterMode(display=False) as fc:
            model(video)
    assert work.forward_flops(network, 3, frames, size) \
        == fc.get_total_flops()


def test_train_operations_triple_the_forward_but_the_stem():
    fwd = work.items(TINY_NETWORK, 2, 4, 32, train=False)
    both = work.items(TINY_NETWORK, 2, 4, 32, train=True)
    bwd = sum(i.flops for i in both if i.direction == "bwd")
    stem = next(i.flops for i in fwd if i.layer == "conv_1.conv_s")
    assert bwd == 2 * sum(i.flops for i in fwd) - stem


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(ROOT, "benchmark", "reference",
                                       "*.py")):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in (
                    "jax", "jaxlib", "flax", "x3d_tpu", "x3d_tpu_torch"), \
                    (path, n)
