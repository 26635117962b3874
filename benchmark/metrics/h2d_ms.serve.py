"""Device ms a request in host-to-device copies."""

from benchmark import layers


def read(ctx):
    return layers.ms_per_call(ctx, "h2d") if ctx.kind == "serve" else None
