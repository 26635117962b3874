"""``tools/ab`` (the JAX package's ``tools/ab.py``) on the CPU at a tiny
config: a train and an eval row with the JAX tool's keys (``impl`` and
``bn_groups`` in place of its TPU lowerings ``dw`` and ``pw``), the plain
versions' row, and the JAX tool's ``--dw`` / ``--pw`` as usage errors."""

import ast
import inspect

import pytest
import torch

from x3d_tpu.tools import ab as jax_ab
from x3d_tpu_torch import variant_config
from x3d_tpu_torch.tools import ab


def _jax_keys(mode):
    """The keys of the JAX tool's row in ``mode``, from its source."""
    tree = ast.parse(inspect.getsource(jax_ab.run_ab))
    rows = [n for n in ast.walk(tree) if isinstance(n, ast.Return)
            and isinstance(n.value, ast.Dict)]
    keys = [[k.value for k in r.value.keys] for r in rows]
    return next(k for k in keys if ("mode" in k) == (mode == "eval"))


def _tiny():
    cfg = variant_config("XS")
    cfg.merge_from_list(["NETWORK.C1_CHANNELS", 4,
                         "NETWORK.DEPTH_FACTOR", 0.34,
                         "DATA.TEMP_DURATION", 4, "DATA.TRAIN_CROP_SIZE", 32,
                         "DATA.TEST_CROP_SIZE", 32,
                         "TEST.NUM_TEMPORAL_VIEWS", 2])
    return cfg


@pytest.mark.parametrize("mode, impl, batch, bn_groups", [
    ("train", "kernels", 2, 1), ("train", "plain", 2, 2),
    ("eval", "kernels", 1, 1)])
def test_run_ab_row_has_the_jax_keys(mode, impl, batch, bn_groups):
    torch.set_num_threads(1)
    row = ab.run_ab("XS", impl, batch, 1, mode=mode, bn_groups=bn_groups,
                    device="cpu", cfg=_tiny(), dtype=torch.float32)
    want = [k for k in _jax_keys(mode) if k not in ("dw", "pw")]
    assert set(row) == set(want) | {"impl", "bn_groups"} - (
        {"bn_groups"} if mode == "eval" else set())
    assert row["impl"] == impl and row["step_ms"] > 0
    clips = batch * (2 if mode == "eval" else 1)
    assert row["clips_per_s"] == pytest.approx(clips / row["step_ms"] * 1e3)
    if mode == "eval":
        assert (row["videos"], row["views"], row["clips"]) == (1, 2, 2)
        assert row["input"] == "4x32^2"
    else:
        assert row["remat"] == "off" and row["bn_groups"] == bn_groups


@pytest.mark.parametrize("flag", ["--dw=aligned", "--pw=conv"])
def test_tpu_lowering_flags_are_a_usage_error(capsys, flag):
    with pytest.raises(SystemExit) as e:
        ab.main([flag, "--device=cpu"])
    assert e.value.code == 2
    assert "TPU lowering" in capsys.readouterr().err


def test_unknown_impl_is_a_usage_error():
    with pytest.raises(SystemExit) as e:
        ab.main(["--impl=xla", "--device=cpu"])
    assert e.value.code == 2
    with pytest.raises(ValueError, match="impl"):
        ab.run_ab("M", "xla", 1, 1, device="cpu")
