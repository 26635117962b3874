"""The dense layers' least time (forward, dx, dW) over their kernels' device
time, training."""

from benchmark import layers


def read(ctx):
    return layers.roofline(ctx, "pw") if ctx.kind == "train" else None
