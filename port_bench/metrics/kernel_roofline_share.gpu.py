"""``kernel_roofline_share`` in the cells that report ``gpu_ms``: the
same reader over the same table and profile."""

from port_bench.manifest import load_module


def read(ctx):
    return load_module("metrics", "kernel_roofline_share", ctx.cell.base).read(ctx)
