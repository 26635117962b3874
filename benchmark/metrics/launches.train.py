"""Device operations a training step, a count."""

from benchmark import layers


def read(ctx):
    return layers.launches(ctx) if ctx.kind == "train" else None
