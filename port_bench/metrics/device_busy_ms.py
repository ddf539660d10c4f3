"""Device ms a frame: the sum of the profiled device operations'
durations (one stream, so they do not overlap) over the profiled
frames."""


def read(ctx):
    return ctx.trace.busy_s * 1e3 / ctx.trace.frames if ctx.trace.ops else None
