"""The window's wall ms a frame, as ``frame_ms`` reads it, in the cells
the host paces: there the host's speed moves it more than any bound a
change could be held to, so it is read here, beside ``gpu_ms``."""


def read(ctx):
    return ctx.wall_ms_per_frame
