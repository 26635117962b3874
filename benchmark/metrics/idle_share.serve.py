"""Share of the traced serving window in which no operation ran on the
device."""

from benchmark import layers


def read(ctx):
    return layers.idle_share(ctx) if ctx.kind == "serve" else None
