"""Host ms inside ``EffectComposer.render`` a frame, over the traced run's
per-frame-synced frames: each starts on an empty launch queue, so the
call returns when the host has enqueued the frame, not when the queue
has room."""


def read(ctx):
    return sum(ctx.enqueue_ms) / len(ctx.enqueue_ms) if ctx.enqueue_ms else None
