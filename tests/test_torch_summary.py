"""The port's summary tool against the golden files the JAX package's tool
wrote (``model_summaries/X3D_{XS,S,M,L,XL}.txt``), byte for byte: the
architecture plan (``models/x3d.build_arch``) and the port model's
parameter and BN-statistic counts under the Flax module names."""

import os

import pytest

from x3d_tpu_torch.config import VARIANTS
from x3d_tpu_torch.tools import summary

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def golden(variant):
    with open(os.path.join(ROOT, "model_summaries", f"X3D_{variant}.txt"),
              "rb") as f:
        return f.read()


@pytest.mark.parametrize("variant", VARIANTS)
def test_summary_equals_the_golden_file(variant):
    assert summary.summarize(variant).encode() == golden(variant)


def test_all_writes_the_golden_files(tmp_path, capsys):
    assert summary.main(["--all", f"--output_dir={tmp_path}"]) == 0
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"X3D_{v}.txt" for v in VARIANTS)
    for v in VARIANTS:
        assert (tmp_path / f"X3D_{v}.txt").read_bytes() == golden(v), v
    assert capsys.readouterr().out.count("wrote ") == len(VARIANTS)


def test_variant_prints_the_table(capsys):
    assert summary.main(["--variant=M"]) == 0
    assert capsys.readouterr().out == golden("M").decode() + "\n"
    with pytest.raises(SystemExit):
        summary.main([])
