"""The benchmark of x3d_tpu_torch on NVIDIA GPUs (``run.py``)."""
