"""Device ms a frame of the operations that start inside the composer's
``stage:ssgi`` range (``trace.stage_busy_ms``)."""

from port_bench.trace import stage_busy_ms


def read(ctx):
    return stage_busy_ms(ctx.trace).get("ssgi")
