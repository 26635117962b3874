"""The benchmark's plain PyTorch reference of X3D: float32, no kernels.
It imports nothing of the program under test."""
