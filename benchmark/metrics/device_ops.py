"""Device operations (kernels, copies, sets) per request or step in the
traced segment, from the profiler's trace. Serves ``device_ops.serve``
and ``device_ops.train``."""


def read(ctx):
    if not ctx.items:
        return None
    return ctx.trace.ops / ctx.items
