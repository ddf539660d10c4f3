"""Device ms a frame of the operations that start inside the program's
``pass:motion_blur.taps`` range (motion blur in taps mode), over the
traced pass's profiled frames (``spans.pass_busy_ms``)."""

from port_bench import spans


def read(ctx):
    return spans.pass_busy_ms(ctx, "motion_blur.taps")
