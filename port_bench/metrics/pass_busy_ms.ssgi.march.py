"""Device ms a frame of the operations that start inside the program's
``pass:ssgi.march`` range (the per-pixel march's launches, inside
``pass:ssgi.trace``), over the traced pass's profiled frames
(``spans.pass_busy_ms``)."""

from port_bench import spans


def read(ctx):
    return spans.pass_busy_ms(ctx, "ssgi.march")
