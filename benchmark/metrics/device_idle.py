"""The share of the traced segment in which no operation ran on the
device, in %. Serves ``device_idle.serve`` and ``device_idle.train``."""


def read(ctx):
    if ctx.trace.window_s <= 0 or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
