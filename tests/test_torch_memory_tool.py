"""``tools/memory`` (the JAX package's ``tools/memory.py``) without a card:
its rows carry the JAX tool's keys and its verdict, here from an injected
measurement of the card's allocator; the measurement itself raises where
there is no card (it has no CPU fallback)."""

import inspect
import json

import pytest
import torch

from x3d_tpu.tools import memory as jax_memory
from x3d_tpu_torch import variant_config
from x3d_tpu_torch.tools import memory

GB = 10**9


@pytest.fixture
def measured(monkeypatch):
    """An injected measurement: 2 GB of arguments, a peak of 9.5 GB, 0.25
    GB left by the step; the calls it saw."""
    seen = []

    def measure(cfg, batch, mode, remat, fold):
        seen.append((batch, mode, remat, fold))
        return {"args": 2 * GB, "total": int(9.5 * GB), "out": GB // 4,
                "remat": "block" if remat in (None, True) else remat or "off"}

    monkeypatch.setattr(memory, "measure", measure)
    return seen


def test_rows_have_the_jax_tools_keys(measured):
    cfg = variant_config("L")
    r = memory.analyze(cfg, 16, "train", None)
    keys = ["batch", "remat", "fold", "input", "temp_gb", "args_gb",
            "out_gb", "total_gb"]
    assert list(r) == keys
    source = inspect.getsource(jax_memory.analyze)
    assert all(f'"{k}"' in source for k in keys)
    assert r == {"batch": 16, "remat": "block", "fold": "None",
                 "input": "16x16x312^2", "temp_gb": 7.5, "args_gb": 2.0,
                 "out_gb": 0.25, "total_gb": 9.5}
    e = memory.analyze(cfg, 2, "eval", "off", False)
    assert e["input"] == "6x16x312^2" and e["fold"] == "False"
    assert measured == [(16, "train", None, None), (2, "eval", "off", False)]


@pytest.mark.parametrize("hbm_gb, fits", [("9.5", True), ("9.4", False)])
def test_main_prints_a_verdict_per_batch(measured, capsys, monkeypatch,
                                         hbm_gb, fits):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert memory.main(["--config",
                        "x3d_tpu_torch/configs/kinetics/X3D_L.yaml",
                        "--batch=16", "--batch=24", "--remat=off",
                        "--fold=on", f"--hbm_gb={hbm_gb}"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["batch"] for r in rows] == [16, 24]
    assert all(r["fits"] is fits and r["remat"] == "off"
               and r["fold"] == "True" for r in rows)
    assert measured == [(16, "train", False, True), (24, "train", False,
                                                     True)]


def test_measure_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CPU fallback"):
        memory.analyze(variant_config("M"), 1, "train", None)
