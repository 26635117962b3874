"""The serving forward's model operations over the window at the dense bf16
peak."""

from benchmark import layers


def read(ctx):
    return layers.mfu(ctx) if ctx.kind == "serve" else None
