"""The depthwise convs' least time (forward, dx, dk) over their kernels' device
time, training."""

from benchmark import layers


def read(ctx):
    return layers.roofline(ctx, "dw") if ctx.kind == "train" else None
