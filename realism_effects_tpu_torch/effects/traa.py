"""TRAA: temporal-reprojection anti-aliasing (`TRAAEffect.js`).

The composer jitters the camera with the R2 sequence (``needs_jitter``);
the frame colour goes through the temporal reprojector with TRAA's
overrides (`TRAAEffect.js:21-31`: maxBlend 0.9, neighborhood clamp,
log transform, confidencePower 4); the accumulated texture is the output.
"""

from __future__ import annotations

import torch

from .. import tracing
from ..ops.temporal_reproject import (TemporalReprojectConfig, halo_rows,
                                      temporal_reproject)
from .base import Effect


class TRAAEffect(Effect):
    name = "traa"
    needs_jitter = True

    def __init__(self, max_blend: float = 0.9,
                 neighborhood_clamp_intensity: float = 1.0,
                 confidence_power: float = 4.0,
                 log_transform: bool = True,
                 full_accumulate: bool = True):
        self.max_blend = max_blend
        self.neighborhood_clamp_intensity = neighborhood_clamp_intensity
        self.full_accumulate = full_accumulate
        self.cfg = TemporalReprojectConfig(
            texture_count=1,
            log_transform=log_transform,
            reproject_specular=(False,),
            neighborhood_clamp=(True,),
            confidence_power=confidence_power,
            input_type="diffuse",
        )

    def static_key(self):
        return (self.cfg, self.full_accumulate)

    def uniforms(self):
        return {
            "max_blend": float(self.max_blend),
            "neighborhood_clamp_intensity": float(self.neighborhood_clamp_intensity),
        }

    def init_state(self, height, width, device):
        return {"history": torch.zeros((height, width, 4), device=device)}

    def apply(self, ctx, color, state):
        out = self._accumulate(ctx, color, state["history"], ctx.velocity,
                               ctx.last_velocity)
        return out[..., :3], {"history": out}

    def _accumulate(self, ctx, color, history, velocity, last_velocity,
                    row_offset: int = 0, frame_height: int | None = None):
        u = ctx.params[self.name]
        g = ctx.params["__global__"]
        with tracing.span("pass:traa.input"):
            inp = torch.cat([color, torch.ones_like(color[..., :1])], dim=-1)
        # fullAccumulate engages only while the camera is still
        # (`TemporalReprojectPass.js:178-183`)
        full_acc = self.full_accumulate and not g["camera_moved"]
        with tracing.span("pass:traa.reproject"):
            (out,) = temporal_reproject(
                [inp], [history], velocity, last_velocity,
                ctx.unjittered_cam, ctx.prev_cam, self.cfg,
                max_blend=u["max_blend"],
                neighborhood_clamp_intensity=u["neighborhood_clamp_intensity"],
                full_accumulate=full_acc,
                keep_data=g["keep_data"],
                row_offset=row_offset, frame_height=frame_height,
            )
        return out

    def split_placement(self):
        return "shard"

    def apply_split(self, sf, ctx, color, state):
        """Per shard, halo-extended by the reprojection's reach."""
        def step(row0, color_, history, velocity, last_velocity):
            out = self._accumulate(ctx, color_, history, velocity,
                                   last_velocity, row0, sf.height)
            return out[..., :3], out

        rgb, out = sf.map(step, halo_rows(self.cfg), color, state["history"],
                          ctx.velocity, ctx.last_velocity)
        return rgb, {"history": out}
