"""The port's CUDA kernels' share of their roofline, in %: the sum of
the least times of a frame's kernel launches over their measured device
time a frame.

The launches are the cell's table (``kernel_launches`` of its traffic
file: kernel, launches a frame, the launch's shape), fixed as data, so
the least time counts the same work whatever later implements it; each
launch's bytes and operations come from ``kernels/<kernel>.py`` and its
least time is max(bytes / 3.35 TB/s, operations / 67 TFLOP/s)
(``roofline.least_s``). The measured time is that of the profiled device
operations of the table's kernels. Where the profile shows no
operation of a kernel in the table (a program that renamed the kernel
or folded it into another), the share is not read: the reader names the
kernel on stderr and returns None, so the table and ``kernels/`` have to
follow the program before the metric reads again."""

import sys

from port_bench.manifest import load_module
from port_bench.roofline import least_s, matches


def read(ctx):
    least = measured = 0.0
    missing = []
    for kernel, entries in _by_kernel(ctx.cell.traffic.get("kernel_launches", [])).items():
        mod = load_module("kernels", kernel, ctx.cell.base)
        us = sum(d for name, _, d in ctx.trace.ops if matches(name, mod.NAME))
        if us == 0.0:
            missing.append(mod.NAME)
            continue
        measured += us / 1e6 / ctx.trace.frames
        least += sum(e["count"] * least_s(*mod.cost(e["params"])) for e in entries)
    if missing:
        print(f"[kernel_roofline_share] not read: the profile shows no "
              f"operation of {', '.join(missing)}", file=sys.stderr)
        return None
    return 100.0 * least / measured if measured else None


def _by_kernel(table):
    out = {}
    for e in table:
        out.setdefault(e["kernel"], []).append(e)
    return out
