"""TAA (upstream `TAAPass.js`, `taa.frag:9-16`), per pixel: the first
frame the camera stands still (``camera_not_moved_frames`` 0) passes
the jittered frame's colour through; after n still frames the running
average ``mix(acc, color, 1 / (n + 1))``, acc the last output. The
output is the new average and the state."""

from __future__ import annotations

from .common import mix


def step(rec):
    ctx, color = rec["ctx"], rec["color"]
    n = float(ctx.params["__global__"]["camera_not_moved_frames"])
    out = color if n == 0.0 else mix(rec["state"]["accumulated"], color, 1.0 / (n + 1.0))
    return out, {"accumulated": out}
