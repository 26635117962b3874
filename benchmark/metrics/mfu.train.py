"""The training step's model operations (3x the forward) over the window at the
dense bf16 peak."""

from benchmark import layers


def read(ctx):
    return layers.mfu(ctx) if ctx.kind == "train" else None
