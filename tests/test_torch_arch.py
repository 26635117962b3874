"""The port's config, expansion math and architecture plan against the JAX
package: identical YAMLs and schema, identical plans for all five
variants, and the published parameter counts (built on the ``meta``
device, so nothing is allocated)."""

import dataclasses
import filecmp
import os

import numpy as np
import pytest
import torch

import x3d_tpu
import x3d_tpu_torch
from x3d_tpu import utils as jax_utils
from x3d_tpu.models import build_arch as jax_build_arch
from x3d_tpu_torch import utils
from x3d_tpu_torch.models import build_arch, create_model

VARIANTS = ("XS", "S", "M", "L", "XL")


def _yaml(pkg, name):
    return os.path.join(os.path.dirname(pkg.__file__), "configs", "kinetics",
                        f"X3D_{name}.yaml")


@pytest.mark.parametrize("name", VARIANTS)
def test_yaml_is_a_byte_copy(name):
    assert filecmp.cmp(_yaml(x3d_tpu_torch, name), _yaml(x3d_tpu, name),
                       shallow=False)


def test_default_schema_matches():
    assert x3d_tpu_torch.get_default_config() == x3d_tpu.get_default_config()


@pytest.mark.parametrize("name", VARIANTS)
def test_build_arch_matches_jax(name):
    got = build_arch(x3d_tpu_torch.variant_config(name))
    want = jax_build_arch(x3d_tpu.variant_config(name))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("name,total", [
    ("XS", 3_795_830), ("S", 3_795_830), ("M", 3_795_830),
    ("L", 6_212_600), ("XL", 11_176_530)])
def test_param_count_parity(name, total):
    """Parameters plus BN running statistics, as the JAX package counts
    ``params`` and ``batch_stats``."""
    model = create_model(x3d_tpu_torch.variant_config(name), device="meta")
    tensors = list(model.parameters()) + list(model.buffers())
    assert sum(t.numel() for t in tensors) == total


def test_expansion_math_matches_jax():
    for width in (4, 12, 24, 48, 54, 96, 192, 432):
        for mult in (0, 0.0625, 1.0, 2, 2.25, 2.9):
            assert utils.round_width(width, mult) == \
                jax_utils.round_width(width, mult)
    for repeats in (1, 2, 3, 5):
        for mult in (0, 0.34, 2.2, 5.0):
            assert utils.round_repeats(repeats, mult) == \
                jax_utils.round_repeats(repeats, mult)


def test_normalize_matches_jax():
    clips = np.random.default_rng(0).integers(0, 256, (2, 3, 4, 4, 3),
                                              dtype=np.uint8)
    mean, std = (0.433, 0.404, 0.377), (0.151, 0.148, 0.157)
    want = np.asarray(jax_utils.normalize(clips.astype(np.float32), mean,
                                          std))
    got = utils.normalize(torch.from_numpy(clips), mean, std).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_denormalize_matches_jax(seed):
    """The inverse of normalize on seeded uint8-range clips, standardised
    by the JAX package: the same pixels after the uint8 cast, bit for bit
    (and the pixels the clips started from, but for float rounding)."""
    clips = np.random.default_rng(seed).integers(0, 256, (2, 3, 4, 4, 3),
                                                 dtype=np.uint8)
    mean, std = (0.45, 0.45, 0.45), (0.225, 0.225, 0.225)
    x = np.asarray(jax_utils.normalize(clips.astype(np.float32), mean, std))
    want = np.asarray(jax_utils.denormalize(x, mean, std))
    got = utils.denormalize(torch.from_numpy(x.copy()), mean, std)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want.astype(int) - clips).max() <= 1


def test_device_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        utils.resolve_device()
    assert utils.resolve_device("cpu") == torch.device("cpu")
