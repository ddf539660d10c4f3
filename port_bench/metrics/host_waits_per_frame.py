"""Host synchronisations with the card a frame inside ``render()``, named
(inside a program ``wait:`` span) and unnamed, counted by the program's
tracing from torch's sync debug mode over the traced pass's synced
frames, each started on an empty queue (``spans.py``)."""

from port_bench import spans


def read(ctx):
    return spans.waits_per_frame(ctx)
