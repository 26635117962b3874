"""The port's training step on the card: through the kernels against the
same step through their plain versions, the launches per step, and that
the step is deterministic.  Every test here needs a CUDA card (marker
``cuda``) and none imports JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_train_card.py``.

Tiny XS geometry (``C1_CHANNELS=4, DEPTH_FACTOR=0.34``, 10 classes), T=4,
32² crop, batch 4, SGD.  Tolerances (float32, TF32 off for cuDNN and
matmul; the kernels sum in another order than cuDNN and cuBLAS, and the
difference grows through the backward of 13 blocks: the first blocks'
gradients, which cancel down to 1e-4 of the head's, differ by up to 5e-4
of their own size): loss rtol 1e-5; each gradient within 1e-3 of its
leaf's largest |gradient|; each updated parameter within 1e-3 of its
leaf's largest update plus 2 float32 ulps; running statistics within 1e-5
of their leaf's largest value.
"""

import copy

import pytest
import torch

from x3d_tpu_torch import ops, variant_config
from x3d_tpu_torch.data import synthetic_batches
from x3d_tpu_torch.models import build_arch, create_model
from x3d_tpu_torch.ops import depthwise, dw_fused, pointwise, pw_stats
from x3d_tpu_torch.train import create_train_state, make_train_step


def _counters():
    return {"K1": depthwise.depthwise_conv3d,
            "K2": dw_fused.dw_bn_act_conv,
            "K3": dw_fused.dw_bn_act_conv_bwd,
            "K4 dx": depthwise.depthwise_conv3d_dx,
            "K4 dk": depthwise.depthwise_conv3d_dk,
            "K5": pw_stats.pw_conv_stats,
            "K6": pw_stats.pw_act_conv_stats,
            "K7": pointwise.pw_conv,
            "K8": depthwise.depthwise_conv3d_pbwd}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tiny():
    cfg = variant_config("XS")
    cfg.NETWORK.C1_CHANNELS = 4
    cfg.NETWORK.DEPTH_FACTOR = 0.34
    cfg.NETWORK.NUM_CLASSES = 10
    cfg.DATA.TEMP_DURATION = 4
    cfg.DATA.TRAIN_CROP_SIZE = 32
    cfg.TRAIN.DATASET_SIZE = 8
    cfg.TRAIN.BATCH_SIZE = 4
    cfg.TRAIN.OPTIMIZER = "sgd"
    return cfg


def _run(cfg, model, snapshot, batch, plain=False):
    model.load_state_dict(snapshot)
    state = create_train_state(cfg, model)
    step = make_train_step(model, cfg.NETWORK.WEIGHT_DECAY)
    for fn in _counters().values():
        fn.launches = 0
    gen = torch.Generator(device=batch["video"].device).manual_seed(3)
    if plain:
        with ops.plain_versions():
            _, metrics = step(state, batch, gen)
    else:
        _, metrics = step(state, batch, gen)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in _counters().items()}
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return (float(metrics["loss"]), grads,
            copy.deepcopy(model.state_dict()), launches)


@pytest.mark.cuda
def test_kernel_step_matches_plain_step(cuda):
    cfg = _tiny()
    model = create_model(cfg, dtype=torch.float32, device=cuda, seed=1)
    snapshot = copy.deepcopy(model.state_dict())
    batch = next(synthetic_batches(cfg, 4, dtype=torch.float32, device=cuda))
    loss, grads, after, launches = _run(cfg, model, snapshot, batch)
    p_loss, p_grads, p_after, p_launches = _run(cfg, model, snapshot, batch,
                                                plain=True)
    arch = build_arch(cfg)
    n_s2 = len(arch.stages)
    n_s1 = sum(len(b) - 1 for b in arch.stages)
    # 4 frames are fewer than the stem's 5 temporal taps, so its backward
    # keeps K4 (K8 = 0); K7 runs the stage entries' convs a and c, the
    # projections and conv_5, forward and dx
    assert launches == {"K1": 1 + n_s2, "K2": n_s1, "K3": n_s1,
                        "K4 dx": 1 + n_s2, "K4 dk": 1 + n_s2, "K5": n_s1,
                        "K6": n_s1, "K7": 2 * (3 * n_s2 + 1), "K8": 0}
    assert set(p_launches.values()) == {0}
    assert abs(loss - p_loss) <= 1e-5 * abs(p_loss)
    for n, g in p_grads.items():
        tol = 1e-3 * g.abs().max().item() + 1e-9
        assert (grads[n] - g).abs().max().item() <= tol, n
    for n, v in p_after.items():
        if n.endswith(("mean", "var")):
            tol = 1e-5 * v.abs().max().item()
        else:
            moved = (v - snapshot[n]).abs().max().item()
            tol = 1e-3 * moved + 2.4e-7 * v.abs().max().item()
        assert (after[n] - v).abs().max().item() <= tol, n


@pytest.mark.cuda
def test_bf16_step_is_deterministic(cuda):
    """No reduction uses atomics: two runs of one step from one state give
    bit-identical losses, gradients and parameters (cuDNN, which runs the
    stem's full conv, is asked for its deterministic algorithms)."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _check_deterministic(cuda)
    finally:
        torch.backends.cudnn.deterministic = old


def _check_deterministic(cuda):
    cfg = _tiny()
    model = create_model(cfg, dtype=torch.bfloat16, device=cuda, seed=2)
    snapshot = copy.deepcopy(model.state_dict())
    batch = next(synthetic_batches(cfg, 4, device=cuda))
    first = _run(cfg, model, snapshot, batch)
    second = _run(cfg, model, snapshot, batch)
    assert first[0] == second[0] and torch.isfinite(torch.tensor(first[0]))
    for n in first[1]:
        assert torch.equal(first[1][n], second[1][n]), n
    for n in first[2]:
        assert torch.equal(first[2][n], second[2][n]), n
