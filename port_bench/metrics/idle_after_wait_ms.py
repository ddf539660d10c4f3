"""Device idle ms a frame in the gaps between device operations that
start while the host is inside a program ``wait:`` span, over the
traced pass's profiled frames (``spans.py``)."""

from port_bench import spans


def read(ctx):
    return spans.idle_after_wait_ms(ctx)
