"""Device ms a training step in operations of no kernel class: PyTorch's
elementwise work, copies, reductions."""

from benchmark import layers


def read(ctx):
    return layers.ms_per_call(ctx, None) if ctx.kind == "train" else None
