"""The depthwise convs' least time (forward) over their kernels' device time,
serving."""

from benchmark import layers


def read(ctx):
    return layers.roofline(ctx, "dw") if ctx.kind == "serve" else None
