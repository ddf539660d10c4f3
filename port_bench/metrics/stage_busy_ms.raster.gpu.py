"""Device ms a frame of the operations that start inside the composer's
``stage:raster`` range (``trace.stage_busy_ms``), in the cells that report
``gpu_ms``."""

from port_bench.trace import stage_busy_ms


def read(ctx):
    return stage_busy_ms(ctx.trace).get("raster")
