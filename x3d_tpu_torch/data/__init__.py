"""Input data for the port: synthetic batches (real pipelines come later)."""

from x3d_tpu_torch.data.synthetic import synthetic_batches  # noqa: F401
