"""Host ms a frame inside the program's ``wait:`` spans: the host blocked
on the card at an upload or a read back, over the traced pass's synced
frames, each started on an empty queue (``spans.py``)."""

from port_bench import spans


def read(ctx):
    return spans.wait_ms(ctx)
