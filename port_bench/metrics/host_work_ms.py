"""Host ms a frame inside ``render()`` outside its waits on the card: the
harness's untraced synced frames' host ms (``host_enqueue_ms``) less the
program's ``wait:`` spans' ms a frame in the traced pass
(``host_wait_ms``; ``spans.py``)."""

from port_bench import spans


def read(ctx):
    return spans.work_ms(ctx)
