"""Every kernel against its plain version at X3D-M's long-cycle multigrid
phase 0 (256 clips of 4x160²) and phase 1 (128 clips of 8x160²): the
shapes and full batches a multigrid step gives each kernel; and the
kernels with temporal taps (K1, K4 dx and dk, K2, K3) at X3D-XS's phase 0
(1024 clips of 1x112²) and phase 1 (512 clips of 2x112²), where every
clip has fewer frames than the stem's 5 taps and the fused segments' 3.
Each case runs the kernel file's own card test
(``test_kernel_matches_plain_on_card`` and K8's
``test_kernel_matches_plain_and_k4_on_card``) at the new shape, with that
file's checks, bodies and tolerances, in float32 and bfloat16:

* K1 at the stem (temporal body; 4, 2 and 1 frames are fewer than its 5
  taps) and the four stride-2 stage entries (ring body);
* K4 dx and dk at the stage entries (phase and ring bodies) and, where
  the clip has fewer frames than the stem's taps, at the stem (gather and
  generic bodies: K8 cannot take them);
* K8 at X3D-M phase 1's stem;
* K2 and K3 at the fused segments, K5 and K6 at the stride-1 blocks' convs
  a and c, K7 (forward, dx and dW) at every bulk 1x1x1 conv the step gives
  it.

The files draw their inputs with numpy's generator, which would take
minutes at 10^8-10^9 values; here the same calls draw from torch's
(standard normal and uniform on [0, 1), float32, seeded).  Every test needs
a CUDA card (marker ``cuda``) and none imports JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_multigrid_card.py``.
"""

import numpy as np
import pytest
import torch

import test_torch_depthwise as k1_tests
import test_torch_depthwise_bwd as k4_tests
import test_torch_depthwise_pbwd as k8_tests
import test_torch_dw_fused as k2_tests
import test_torch_dw_fused_bwd as k3_tests
import test_torch_pointwise as k7_tests
import test_torch_pw_stats as k56_tests
from test_torch_dw_fused import multigrid_phases, x3d_planes
from x3d_tpu_torch.models import build_arch
from x3d_tpu_torch.tools import profile_pointwise

MODULES = (k1_tests, k4_tests, k8_tests, k2_tests, k3_tests, k7_tests,
           k56_tests)


class _FastRandom:
    """numpy's ``default_rng`` surface as the card tests call it, drawn by
    torch in float32."""

    def __init__(self, seed):
        self._gen = torch.Generator().manual_seed(int(seed))

    def normal(self, loc=0.0, scale=1.0, size=None):
        return (torch.randn(size, generator=self._gen) * scale + loc).numpy()

    def uniform(self, low=0.0, high=1.0, size=None):
        return (torch.rand(size, generator=self._gen) * (high - low)
                + low).numpy()


class _FastNumpy:
    """numpy, but for ``random.default_rng``."""

    class random:
        default_rng = _FastRandom

    def __getattr__(self, name):
        return getattr(np, name)


def _phases(variant="M"):
    """(name, clips, config) of X3D-``variant``'s phases 0 and 1."""
    prefix = "mg" if variant == "M" else f"{variant}-mg"
    return [(f"{prefix}{i}", c.TRAIN.BATCH_SIZE, c)
            for i, c in multigrid_phases(variant)[:2]]


TEMPORAL = ("M", "XS")        # K1, K4, K2 and K3: X3D-M and X3D-XS


def _k1_cases():
    return [(f"{p}-{name}", (shape, kdims, strides, pads))
            for v in TEMPORAL for p, B, c in _phases(v)
            for name, shape, kdims, strides, pads in k1_tests._model_convs(
                v, B, True, c)]


def _k4_cases():
    out = []
    for v in TEMPORAL:
        for p, B, c in _phases(v):
            out += [(f"{p}-stage{st}", ((B, *entry), (3, 3, 3), (1, 2, 2),
                                        "SAME"))
                    for st, entry, _ in x3d_planes(v, True, c)]
            stem = k1_tests._model_convs(v, B, True, c)[0]
            if stem[1][1] < stem[2][0]:    # fewer frames than taps: K4's
                out.append((f"{p}-stem", stem[1:]))
    return out


def _k8_cases():
    out = []
    for p, B, c in _phases():
        _, shape, kdims, _, _ = k1_tests._model_convs("M", B, True, c)[0]
        if shape[1] >= kdims[0]:
            out.append((f"{p}-stem", (shape, kdims)))
    return out


def _segment_cases():
    return [(f"{p}-stage{st}", ((B, *seg), (3, 3, 3)))
            for v in TEMPORAL for p, B, c in _phases(v)
            for st, _, seg in x3d_planes(v, True, c)]


def _k56_cases():
    out = []
    for p, B, c in _phases():
        arch = build_arch(c)
        for (st, _, seg), blocks in zip(x3d_planes("M", True, c),
                                        arch.stages):
            b = blocks[1]
            T, H, W, _ = seg
            out += [(f"{p}-stage{st}-K5", (False, (B, T, H, W,
                                                   b.in_channels),
                                           b.inner_channels)),
                    (f"{p}-stage{st}-K6", (True, (B, T, H, W,
                                                  b.inner_channels),
                                           b.out_channels))]
    return out


def _k7_cases():
    out = {}
    for p, B, c in _phases():
        for name, shape, N, strides, _ in profile_pointwise.cases(
                c, build_arch(c), B, c.DATA.TRAIN_CROP_SIZE, True):
            out.setdefault((shape, N, strides), f"{p}-{name}")
    return [(i, case) for case, i in out.items()]


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for mod in MODULES:
        monkeypatch.setattr(mod, "np", _FastNumpy())
    yield torch.device("cuda")
    torch.cuda.empty_cache()


def _cases(fn):
    cases = fn()
    return pytest.mark.parametrize("case", [c for _, c in cases],
                                   ids=[i for i, _ in cases])


DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])


@pytest.mark.cuda
@DTYPES
@_cases(_k1_cases)
def test_k1_at_multigrid_phases(cuda, dtype, case):
    k1_tests.test_kernel_matches_plain_on_card(cuda, dtype, *case)


@pytest.mark.cuda
@DTYPES
@_cases(_k4_cases)
def test_k4_at_multigrid_phases(cuda, dtype, case):
    k4_tests.test_kernel_matches_plain_on_card(cuda, dtype, *case)


@pytest.mark.cuda
@DTYPES
@_cases(_k8_cases)
def test_k8_at_multigrid_phases(cuda, dtype, case):
    k8_tests.test_kernel_matches_plain_and_k4_on_card(cuda, dtype, *case)


@pytest.mark.cuda
@DTYPES
@_cases(_segment_cases)
def test_k2_at_multigrid_phases(cuda, dtype, case):
    k2_tests.test_kernel_matches_plain_on_card(cuda, dtype, *case)


@pytest.mark.cuda
@DTYPES
@_cases(_segment_cases)
def test_k3_at_multigrid_phases(cuda, dtype, case):
    k3_tests.test_kernel_matches_plain_on_card(cuda, dtype, *case)


@pytest.mark.cuda
@DTYPES
@_cases(_k56_cases)
def test_k5_k6_at_multigrid_phases(cuda, dtype, case):
    act, shape, cout = case
    k56_tests.test_kernel_matches_plain_on_card(cuda, dtype, act, shape,
                                                cout)


@pytest.mark.cuda
@DTYPES
@_cases(_k7_cases)
def test_k7_at_multigrid_phases(cuda, dtype, case):
    k7_tests.test_kernel_matches_plain_on_card(cuda, dtype, *case)
