"""Per-replica (grouped) BatchNorm through the kernels on the card: the
(C, B) coefficient columns of two BN groups, which differ from sample to
sample, through K5, K2, K3 and K6, against the same work through their
plain versions.  Every test here needs a CUDA card (marker ``cuda``) and
none imports JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_parallel_card.py``.

* A stride-1 bottleneck of X3D-M's stage-2 widths (24 -> 54 -> 24, SE) in
  training mode with ``groups = 2``: K5 gives conv ``a``'s sums, bn_a's
  grouped coefficients go to K2 as per-sample columns, K2's sums give
  bn_b's, K6 takes bn_b's columns with the SE gate folded in, and the
  backward runs K3 and the kernels' own backwards.  Float32, TF32 off: the
  output within 1e-4 of its largest value, every gradient within 1e-3 of
  its largest value (the kernels sum in another order), bfloat16: the
  output within 2e-2 and the gradients within 5e-2 of their largest value.
* The tiny XS training step with ``bn_groups = 2`` through the kernels
  against the plain versions, at ``tests/test_torch_train_card.py``'s
  tolerances, with the ungrouped step's launches.
"""

import copy

import pytest
import torch

from x3d_tpu_torch import ops
from x3d_tpu_torch.models import build_arch, create_model
from x3d_tpu_torch.models.x3d import BlockSpec, Bottleneck
from x3d_tpu_torch.ops import dw_fused, pw_stats

import test_torch_train_card as tc


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _block_run(block, x, g):
    xx = x.clone().requires_grad_()
    for p in block.parameters():
        p.grad = None
    y = block(xx)
    y.float().backward(g)
    torch.cuda.synchronize()
    return y.float(), xx.grad.float(), {n: p.grad.clone()
                                        for n, p in block.named_parameters()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_grouped_columns_through_kernels(cuda, dtype):
    spec = BlockSpec(24, 54, 24, 1, True, 8)
    block = Bottleneck(spec, 3, 1e-5, 0.9, dtype)
    gen = torch.Generator().manual_seed(0)
    for m in block.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    for bn in (block.bn_a, block.bn_b, block.bn_c):
        bn.groups = 2
        with torch.no_grad():
            bn.norm.scale.uniform_(0.5, 1.5, generator=gen)
            bn.norm.bias.normal_(0, 0.3, generator=gen)
    block = block.to(cuda).train()
    # the two groups' activations differ in scale and offset, so their
    # statistics and columns do
    x = torch.randn((4, 4, 28, 28, 24), device=cuda)
    x[2:] = 2.0 * x[2:] + 0.5
    x = x.to(dtype)
    g = torch.randn((4, 4, 28, 28, 24), device=cuda)
    fns = (pw_stats.pw_conv_stats, dw_fused.dw_bn_act_conv,
           dw_fused.dw_bn_act_conv_bwd, pw_stats.pw_act_conv_stats)
    before = [f.launches for f in fns]
    state = copy.deepcopy(block.state_dict())
    got = _block_run(block, x, g)
    assert [f.launches - b for f, b in zip(fns, before)] == [1, 1, 1, 1]
    block.load_state_dict(state)
    with ops.plain_versions():
        want = _block_run(block, x, g)
    tol_y, tol_g = (1e-4, 1e-3) if dtype == torch.float32 else (2e-2, 5e-2)
    assert (got[0] - want[0]).abs().max() <= tol_y * want[0].abs().max()
    assert (got[1] - want[1]).abs().max() <= tol_g * want[1].abs().max()
    for n, w in want[2].items():
        assert (got[2][n] - w).abs().max() <= tol_g * w.abs().max() + 1e-9, n


@pytest.mark.cuda
def test_grouped_step_matches_plain_step(cuda):
    cfg = tc._tiny()
    model = create_model(cfg, dtype=torch.float32, device=cuda, seed=1,
                         bn_groups=2)
    snapshot = copy.deepcopy(model.state_dict())
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((4, 4, 32, 32, 3), generator=gen, device=cuda)
    x[2:] = 1.5 * x[2:] + 0.3
    batch = {"video": x, "label": torch.tensor([1, 2, 3, 4], device=cuda)}
    loss, grads, after, launches = tc._run(cfg, model, snapshot, batch)
    p_loss, p_grads, p_after, p_launches = tc._run(cfg, model, snapshot,
                                                   batch, plain=True)
    arch = build_arch(cfg)
    n_s2 = len(arch.stages)
    n_s1 = sum(len(b) - 1 for b in arch.stages)
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
