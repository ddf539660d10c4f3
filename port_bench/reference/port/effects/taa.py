"""TAA: accumulative anti-aliasing for a still camera (`TAAPass.js`,
`taa.frag`): while the camera is still, the jittered frame is blended
into a running average ``mix(acc, color, 1 / (n + 1))``; any camera
motion restarts it."""

from __future__ import annotations

import torch

from .base import Effect


class TAAPass(Effect):
    name = "taa"
    needs_jitter = True

    def init_state(self, height, width, device):
        return {"accumulated": torch.zeros((height, width, 3), device=device)}

    def apply(self, ctx, color, state):
        n = float(ctx.params["__global__"]["camera_not_moved_frames"])
        if n == 0.0:
            # `taa.frag:9-16`: the first still frame shows the input
            out = color
        else:
            acc = state["accumulated"]
            out = acc + (color - acc) * (1.0 / (n + 1.0))
        return out, {"accumulated": out}
