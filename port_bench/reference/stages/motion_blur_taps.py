"""Motion blur, taps mode: upstream's `motion_blur.frag` per pixel (the
integral `:23-42`, the early-out `:13-18`). The velocity scaled by the
intensity is the segment; frameSpeed = (1/100) / dt, in float32; the
segment runs from ``clamp(uv + (jitter * vel * noise.rg - vel / 2) *
frameSpeed, min 0)`` to ``clamp(uv + (jitter * vel * noise.rg + vel / 2)
* frameSpeed, max 1)``, noise the frame's blue noise; ``samples + 1``
bilinear taps of the float16 colour (the composer's HalfFloat target)
are spread evenly over it, the pixel's own colour is added once, and the
sum is divided by ``samples + 2``. A pixel whose velocity is nought (its
squared length at most 1e-9) keeps its colour.

Written as each tap's fetch of the whole frame; ``samples`` is the
effect's own.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import bilinear, blue_noise, half, mix, uv_grid


def step(rec):
    ctx, color = rec["ctx"], rec["color"]
    u = ctx.params["motion_blur"]
    samples = int(rec["effect"].samples)
    velocity = ctx.velocity.velocity
    h, w = color.shape[:2]
    dev = color.device
    vel = velocity * u["intensity"]
    moved = (velocity * velocity).sum(-1) > 1e-9
    speed = float(np.float32(1.0 / 100.0) / np.float32(u["delta_time"]))
    jitter = u["jitter"] * vel * blue_noise(h, w, ctx.frame_index, dev)[..., :2]
    uv = uv_grid(h, w, dev)
    start = torch.clamp(uv + (jitter - vel * 0.5) * speed, min=0.0)
    end = torch.clamp(uv + (jitter + vel * 0.5) * speed, max=1.0)
    src = half(color)
    acc = color
    for i in range(samples + 1):
        acc = acc + bilinear(src, mix(start, end, i / float(samples)))
    blurred = acc / (samples + 2.0)
    return torch.where(moved[..., None], blurred, color), rec["state"]
