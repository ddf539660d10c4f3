"""Device operations (kernels, memcpys, memsets) a frame, from the
profiled frames."""


def read(ctx):
    return len(ctx.trace.ops) / ctx.trace.frames if ctx.trace.ops else None
