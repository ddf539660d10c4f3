"""AO effects (`AOEffect.js`, `HBAOEffect.js`, `GTAOEffect.js`): AO pass
-> Poisson denoise -> multiplicative compose. As in the JAX package, the
GTAO wiring is the repaired one (the reference's is unexported)."""

from __future__ import annotations

from .. import tracing
from ..core.framebuffers import GBuffer
from ..core.math3d import uv_grid
from ..core.sampling import sample_bilinear, sample_nearest
from ..ops import ao as ops_ao
from ..ops.ao import AOConfig, gtao, hbao
from ..ops.compose import ao_compose
from ..ops.poisson_denoise import PoissonDenoiseConfig, poisson_denoise_ao
from ..parallel.halo import poisson_denoise_ao_blocks
from .base import Effect


def nearest_downsampled(gb: GBuffer, lo_uv) -> GBuffer:
    """Nearest-downsampled G-buffer for the scaled AO pass."""
    r = lambda t: sample_nearest(t, lo_uv)
    return GBuffer(diffuse=r(gb.diffuse), normal=r(gb.normal),
                   roughness=r(gb.roughness), metalness=r(gb.metalness),
                   emissive=r(gb.emissive), depth=r(gb.depth))


class AOEffect(Effect):
    """Base AO orchestrator; subclasses select the AO kernel."""

    name = "ao"
    kind = "hbao"
    #: the ``pass:<kind>.<pass>`` span names, built once
    pass_spans = {p: f"pass:hbao.{p}" for p in ("ao", "denoise", "compose")}

    def __init__(self, spp: int = 8, distance: float = 2.0,
                 distance_power: float = 1.0, power: float = 2.0,
                 bias: float = 40.0, thickness: float = 0.075,
                 color=(0.0, 0.0, 0.0), use_normal_texture: bool = True,
                 denoise_iterations: int = 1, radius: float = 3.0,
                 phi: float = 0.5, luma_phi: float = 5.0,
                 depth_phi: float = 2.0, normal_phi: float = 3.25,
                 animated_noise: bool = True,
                 resolution_scale: float = 1.0):
        self.cfg = AOConfig(
            spp=spp, distance=distance, distance_power=distance_power,
            bias=bias, thickness=thickness, animated_noise=animated_noise,
            use_normal_texture=use_normal_texture,
        )
        self.denoise_cfg = PoissonDenoiseConfig(
            iterations=denoise_iterations, radius=radius, phi=phi,
            luma_phi=luma_phi, depth_phi=depth_phi, normal_phi=normal_phi,
        )
        self.power = power
        self.color = tuple(color)
        #: AO pass at a scaled render size, denoise/compose at full size
        #: (`defaultAOOptions.resolutionScale`, `AOEffect.js:8-21`)
        self.resolution_scale = float(resolution_scale)

    def static_key(self):
        return (self.kind, self.cfg, self.denoise_cfg, self.color,
                self.resolution_scale)

    def uniforms(self):
        return {"power": float(self.power)}

    def _ao(self, ctx, gbuffer):
        raise NotImplementedError

    def apply(self, ctx, color, state):
        """AO, its Poisson denoise and the compose, one
        ``pass:<kind>.<pass>`` span each."""
        gb = ctx.gbuffer
        spans = self.pass_spans
        with tracing.span(spans["ao"]):
            if self.resolution_scale < 1.0:
                h, w = gb.depth.shape
                h2 = max(int(h * self.resolution_scale), 8)
                w2 = max(int(w * self.resolution_scale), 8)
                gb_lo = nearest_downsampled(gb, uv_grid(h2, w2, gb.device))
                normal_lo, ao_lo = self._ao(ctx, gb_lo)
                full_uv = uv_grid(h, w, gb.device)
                ao = sample_bilinear(ao_lo, full_uv)
                normal = sample_nearest(normal_lo, full_uv)
            else:
                normal, ao = self._ao(ctx, gb)
        if self.denoise_cfg.iterations > 0:
            with tracing.span(spans["denoise"]):
                ao = poisson_denoise_ao(ao, normal, gb, ctx.frame_index,
                                        self.denoise_cfg)
        with tracing.span(spans["compose"]):
            return self._compose(ctx, color, ao, gb.depth), state

    def _compose(self, ctx, color, ao, depth):
        return ao_compose(color, ao, depth, power=ctx.params[self.name]["power"],
                          ao_color=self.color)

    def split_placement(self):
        """Per shard on the fused HBAO kernel with the G-buffer's normals
        at full resolution; whole otherwise (GTAO, the unfused route, a
        depth-derived normal or a scaled pass)."""
        fused = (self.kind == "hbao" and ops_ao.USE_FUSED_KERNEL
                 and self.cfg.use_normal_texture)
        return "shard" if fused and self.resolution_scale >= 1.0 else "whole"

    def apply_split(self, sf, ctx, color, state):
        """HBAO per shard, halo-extended by its window (``window_ky``
        rows); the AO Poisson passes with their own halo each; the
        compose per shard."""
        gb = ctx.gbuffer
        ao = sf.map(lambda row0, depth, normal: ops_ao.hbao(
            depth, normal, ctx.unjittered_cam, ctx.frame_index, self.cfg,
            row0, sf.height)[1], int(self.cfg.window_ky), gb.depth, gb.normal)
        if self.denoise_cfg.iterations > 0:
            ao = poisson_denoise_ao_blocks(ao, gb, ctx.frame_index,
                                           self.denoise_cfg, sf.mesh,
                                           (sf.height, sf.width))
        out = sf.map(lambda _row0, c, a, d: self._compose(ctx, c, a, d), 0,
                     color, ao, gb.depth)
        return out, state


class HBAOEffect(AOEffect):
    """Horizon-based AO (`HBAOEffect.js`)."""

    name = "hbao"
    kind = "hbao"

    def _ao(self, ctx, gbuffer):
        normal = gbuffer.normal if self.cfg.use_normal_texture else None
        return hbao(gbuffer.depth, normal, ctx.unjittered_cam,
                    ctx.frame_index, self.cfg)


class GTAOEffect(AOEffect):
    """Ground-truth AO (`GTAOEffect.js`); 16 samples by default, the
    reference's Vogel table."""

    name = "gtao"
    kind = "gtao"
    pass_spans = {p: f"pass:gtao.{p}" for p in ("ao", "denoise", "compose")}

    def __init__(self, spp: int = 16, **kw):
        super().__init__(spp=spp, **kw)

    def _ao(self, ctx, gbuffer):
        return gbuffer.normal, gtao(gbuffer.depth, ctx.unjittered_cam,
                                    ctx.frame_index, self.cfg)
