"""Device ms a training step in NCCL's kernels; nothing where none ran."""

from benchmark import layers


def read(ctx):
    if ctx.kind != "train" or not ctx.class_seconds("nccl"):
        return None
    return layers.ms_per_call(ctx, "nccl")
