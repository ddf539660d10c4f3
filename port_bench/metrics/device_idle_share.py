"""The device's idle share of a frame, in %: 1 - device busy ms a frame
(profiled frames) / the pipelined frames' wall ms a frame (the traced
run's first phase, unprofiled), as ``profile_slice.py`` computes it."""


def read(ctx):
    if not ctx.trace.ops or not ctx.wall_ms_per_frame:
        return None
    busy = ctx.trace.busy_s * 1e3 / ctx.trace.frames
    return 100.0 * (1.0 - busy / ctx.wall_ms_per_frame)
