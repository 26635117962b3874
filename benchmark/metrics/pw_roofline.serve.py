"""The dense layers' least time (forward) over their kernels' device time,
serving."""

from benchmark import layers


def read(ctx):
    return layers.roofline(ctx, "pw") if ctx.kind == "serve" else None
