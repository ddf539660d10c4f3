"""One kernel's share of its roofline, in %: ``kernel_roofline_share``'s
arithmetic over the rows of the cell's ``kernel_launches`` table that
name the kernel alone, read by ``metrics/<kernel>_roofline.py``.
None where the table has no row of the kernel or the profile no
operation of it (a program without the kernel)."""

from __future__ import annotations

from port_bench.manifest import load_module
from port_bench.roofline import least_s, matches


def read(ctx, kernel: str):
    rows = [e for e in ctx.cell.traffic.get("kernel_launches", []) if e["kernel"] == kernel]
    if not rows:
        return None
    mod = load_module("kernels", kernel, ctx.cell.base)
    us = sum(d for name, _, d in ctx.trace.ops if matches(name, mod.NAME))
    if us == 0.0:
        return None
    least = sum(e["count"] * least_s(*mod.cost(e["params"])) for e in rows)
    return 100.0 * least / (us / 1e6 / ctx.trace.frames)
