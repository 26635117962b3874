"""x3d_tpu_torch — the X3D video-recognition system in PyTorch for one
NVIDIA Hopper card (H100), with hand-written CUDA kernels for its
depthwise-conv and bottleneck hot path, forward and backward: serving
(``serving``) and training (``train``).

It does what the JAX package ``x3d_tpu`` does and keeps its layouts,
parameter names and numerics, so weights convert between the two
(``x3d_tpu_torch.convert``).  It imports torch, never jax.  Entry points
run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from x3d_tpu_torch.config import (  # noqa: F401
    VARIANTS,
    CfgNode,
    get_default_config,
    variant_config,
)
