"""TRAA (upstream `TRAAEffect.js`): the frame's colour through the
temporal reprojection with TRAA's options (`TRAAEffect.js:21-31`: log
colour, clamp on, confidence power 4, max blend and clamp intensity
from the frame's uniforms, full accumulation while the camera stands
still), on the unjittered camera; the output is the accumulated colour
(`traa_compose.frag` passes it through)."""

from __future__ import annotations

import torch

from .temporal import reproject


def step(rec):
    ctx, color = rec["ctx"], rec["color"]
    u, g = ctx.params["traa"], ctx.params["__global__"]
    inp = torch.cat([color, torch.ones_like(color[..., :1])], -1)
    (out,) = reproject([inp], [rec["state"]["history"]], ctx.velocity, ctx.last_velocity,
                       ctx.unjittered_cam, ctx.prev_cam, log=True, specular=(False,),
                       power=4.0, input_type="diffuse", max_blend=u["max_blend"],
                       clamp_intensity=u["neighborhood_clamp_intensity"],
                       full_accumulate=not g["camera_moved"], keep_data=g["keep_data"])
    return out[..., :3], {"history": out}
