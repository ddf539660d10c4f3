"""``kernel_roofline_share`` as the entry that moves ``gpu_ms`` (the
cells the host paces list it): the same reader over the same table and
profile."""

from port_bench.manifest import load_module


def read(ctx):
    return load_module("metrics", "kernel_roofline_share", ctx.cell.base).read(ctx)
