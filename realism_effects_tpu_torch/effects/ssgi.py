"""SSGI effect (`SSGIEffect.js`, `SSGIOptions.js`, `Denoiser.js`): trace ->
temporal reprojection -> Poisson denoise -> compose, with the reference's
feedback: the trace reads last frame's composed output
(`SSGIPass.js:88`) and the reprojector's history is last frame's
denoised output (`Denoiser.js:51`), both in this effect's state.

``denoise_mode`` is `Denoiser.js:7`'s ("full" | "full_temporal" |
"denoised" | "temporal"). ``selection`` honours ``Mesh.gi_exclude``
(`SSGIPass.js:71-79`): "mask" sends the excluded meshes' pixels of the
G-buffer to background by its ``mesh_id``; "rerender" runs the whole
chain on the composer's second raster pass without them.

``SSREffect`` (`SSREffect.js`) is the same chain with ``mode = "ssr"``:
the specular ray alone is traced, one texture is reprojected, denoised
and composed over the scene colour.
"""

from __future__ import annotations

import torch

from .. import tracing
from ..core.framebuffers import GBuffer, VelocityBuffer
from ..core.math3d import uv_grid
from ..core.sampling import sample_bilinear, sample_nearest
from ..ops.compose import ssgi_compose
from ..ops.denoiser_compose import denoiser_compose
from ..ops.poisson_denoise import PoissonDenoiseConfig, poisson_denoise
from ..ops.ssgi import PASS_SPANS, SSGIConfig, ssgi, ssgi_split
from ..ops.temporal_reproject import (TemporalReprojectConfig, halo_rows,
                                      temporal_reproject)
from ..parallel.halo import poisson_denoise_blocks
from .base import Effect


def _resize_bilinear(tex, h, w):
    return sample_bilinear(tex, uv_grid(h, w, tex.device))


def _resize_nearest(tex, h, w):
    return sample_nearest(tex, uv_grid(h, w, tex.device))


def _resize_gbuffer(gb: GBuffer, h, w) -> GBuffer:
    r = lambda t: _resize_nearest(t, h, w)
    return GBuffer(diffuse=r(gb.diffuse), normal=r(gb.normal),
                   roughness=r(gb.roughness), metalness=r(gb.metalness),
                   emissive=r(gb.emissive), depth=r(gb.depth))


def _resize_velocity(vel: VelocityBuffer, h, w) -> VelocityBuffer:
    r = lambda t: _resize_nearest(t, h, w)
    return VelocityBuffer(velocity=r(vel.velocity), normal=r(vel.normal),
                          depth=r(vel.depth))


#: quality presets (`SSGIEffect.js:79-99`)
SSGI_PRESETS = {
    "low": dict(steps=10, refine_steps=2, denoise_mode="full_temporal",
                resolution_scale=0.5),
    "medium": dict(steps=20, refine_steps=4, denoise_mode="full"),
}


class SSGIEffect(Effect):
    name = "ssgi"
    mode = "ssgi"

    def __init__(self, distance: float = 10.0, thickness: float = 10.0,
                 env_blur: float = 0.5, importance_sampling: bool = True,
                 steps: int = 20, refine_steps: int = 5,
                 missed_rays: bool = False,
                 denoise_iterations: int = 1, radius: float = 3.0,
                 phi: float = 0.5, luma_phi: float = 5.0,
                 depth_phi: float = 2.0, normal_phi: float = 50.0,
                 roughness_phi: float = 50.0, specular_phi: float = 50.0,
                 denoise_mode: str = "full",
                 fog_color=None, fog_density: float = 0.0,
                 resolution_scale: float = 1.0,
                 use_direct_light: bool = True,
                 env_box: tuple | None = None,
                 preset: str | None = None,
                 selection: str = "mask",
                 output_texture: str | None = None,
                 trace: str = "sweep", sweep_dirs: int = 16,
                 sweep_steps: int = 32, env_fetch_stride: int = 2):
        if preset is not None:
            p = SSGI_PRESETS[preset]
            steps = p.get("steps", steps)
            refine_steps = p.get("refine_steps", refine_steps)
            denoise_mode = p.get("denoise_mode", denoise_mode)
            resolution_scale = p.get("resolution_scale", resolution_scale)
        if selection not in ("mask", "rerender"):
            raise ValueError("selection must be 'mask' or 'rerender'")
        if trace not in ("march", "sweep"):
            raise ValueError("trace must be 'march' or 'sweep'")
        self.distance = distance
        self.thickness = thickness
        self.env_blur = env_blur
        self.denoise_mode = denoise_mode
        self.fog_color = fog_color
        self.fog_density = fog_density
        self.selection = selection
        #: debug routing (`SSGIEffect.js:228-251`): None | "diffuse" |
        #: "specular" | "temporal_diffuse" | "temporal_specular" |
        #: "denoised_diffuse" | "denoised_specular" | "composed"
        self.output_texture = output_texture
        self.resolution_scale = float(resolution_scale)
        self.cfg = SSGIConfig(
            mode=self.mode, steps=steps, refine_steps=refine_steps,
            missed_rays=missed_rays, importance_sampling=importance_sampling,
            use_direct_light=use_direct_light, env_box=env_box, trace=trace,
            sweep_dirs=sweep_dirs, sweep_steps=sweep_steps,
            env_fetch_stride=env_fetch_stride)
        n_tex = 2 if self.mode == "ssgi" else 1
        self.temporal_cfg = TemporalReprojectConfig(
            texture_count=n_tex, log_transform=True,
            reproject_specular=(False, True) if n_tex == 2 else (True,),
            neighborhood_clamp=(True,) * n_tex, confidence_power=0.75,
            input_type="diffuse_specular" if n_tex == 2 else "specular")
        self.denoise_cfg = PoissonDenoiseConfig(
            iterations=denoise_iterations, radius=radius, phi=phi,
            luma_phi=luma_phi, depth_phi=depth_phi, normal_phi=normal_phi,
            roughness_phi=roughness_phi, specular_phi=specular_phi,
            is_specular=(False, True) if n_tex == 2 else (True,))

    def static_key(self):
        return (self.cfg, self.temporal_cfg, self.denoise_cfg,
                self.denoise_mode, self.output_texture, self.selection,
                self.fog_color, self.fog_density, self.resolution_scale)

    def uniforms(self):
        return {"ray_distance": float(self.distance),
                "thickness": float(self.thickness),
                "env_blur": float(self.env_blur)}

    def init_state(self, height, width, device):
        return {
            "history": [torch.zeros((height, width, 4), device=device)
                        for _ in range(self.temporal_cfg.texture_count)],
            "composed": torch.zeros((height, width, 3), device=device),
        }

    def _selected(self, ctx) -> GBuffer:
        """The G-buffer the GI chain sees (`SSGIPass.js:71-79`): excluded
        meshes neither occlude rays nor appear in reflections, and their
        pixels read as background, so the scene colour passes through
        them in the compose."""
        gbuffer = ctx.gbuffer
        if self.selection == "rerender" and ctx.gi_gbuffer is not None:
            return ctx.gi_gbuffer
        gi_w = ctx.params["__global__"].get("gi_mask_meshes")
        if gbuffer.mesh_id is None or gi_w is None or not (gi_w < 0.5).any():
            return gbuffer  # nothing excluded: the identity
        return _mask_gbuffer(gbuffer, gi_w)

    def _reproject(self, ctx, inputs, history, velocity, last_velocity,
                   roughness, row_offset: int = 0,
                   frame_height: int | None = None):
        """2. temporal reprojection (`Denoiser.js:33-42`)."""
        g = ctx.params["__global__"]
        return temporal_reproject(
            inputs, history, velocity, last_velocity, ctx.cam, ctx.prev_cam,
            self.temporal_cfg, max_blend=1.0, neighborhood_clamp_intensity=0.5,
            full_accumulate=not g["camera_moved"], keep_data=g["keep_data"],
            roughness_tex=roughness, row_offset=row_offset,
            frame_height=frame_height)

    def _compose(self, ctx, gbuffer, color, traced, temporal, denoised,
                 row_offset: int = 0, frame_height: int | None = None):
        """4. GI composition (SSR: the specular texture over the scene
        colour), 5. over the scene (+ fog), and the debug routing.
        Returns (output, composed)."""
        rows = dict(row_offset=row_offset, frame_height=frame_height)
        if self.mode == "ssgi":
            composed = denoiser_compose(denoised[0], denoised[1], gbuffer,
                                        ctx.cam, **rows)
        else:
            composed = denoiser_compose(denoised[0], denoised[0], gbuffer,
                                        ctx.cam, scene_color=color,
                                        input_type="specular", **rows)
        out = ssgi_compose(composed, color, gbuffer.depth, ctx.cam,
                           fog_color=self.fog_color,
                           fog_density=self.fog_density)
        if self.output_texture is not None:
            out = {
                "diffuse": traced[0][..., :3],
                "specular": traced[1][..., :3],
                "temporal_diffuse": temporal[0][..., :3],
                "temporal_specular": temporal[-1][..., :3],
                "denoised_diffuse": denoised[0][..., :3],
                "denoised_specular": denoised[-1][..., :3],
                "composed": composed,
            }[self.output_texture]
        return out, composed

    def apply(self, ctx, color, state):
        """The unsplit chain, one ``pass:<mode>.<pass>`` span a pass (the
        trace's own in ``ops.ssgi.ssgi``)."""
        u = ctx.params[self.name]
        spans = PASS_SPANS[self.mode]
        with tracing.span(spans["setup"]):
            gbuffer = self._selected(ctx)

        # 1. the trace; its radiance is last frame's composed output.
        #    With resolution_scale < 1 it runs on a downsampled G-buffer
        #    and is upsampled (`SSGIPass.js:52-57`).
        trace_args = dict(env=ctx.env, cam=ctx.cam, frame=ctx.frame_index,
                          cfg=self.cfg, ray_distance=u["ray_distance"],
                          thickness=u["thickness"], env_blur=u["env_blur"])
        if self.resolution_scale < 1.0:
            h, w = gbuffer.depth.shape
            h2 = max(int(h * self.resolution_scale), 8)
            w2 = max(int(w * self.resolution_scale), 8)
            with tracing.span(spans["setup"]):
                small = (_resize_gbuffer(gbuffer, h2, w2),
                         _resize_velocity(ctx.velocity, h2, w2),
                         _resize_bilinear(state["composed"], h2, w2),
                         _resize_bilinear(color, h2, w2))
            g_diffuse, g_specular = ssgi(*small, **trace_args)
            del small
            with tracing.span(spans["shade"]):
                # nearest for diffuse: bilinear would blend the -1 "no
                # diffuse sample" mark into valid radiance
                g_diffuse = _resize_nearest(g_diffuse, h, w)
                g_specular = _resize_bilinear(g_specular, h, w)
        else:
            g_diffuse, g_specular = ssgi(gbuffer, ctx.velocity,
                                         state["composed"], color, **trace_args)

        inputs = [g_diffuse, g_specular] if self.mode == "ssgi" else [g_specular]
        with tracing.span(spans["reproject"]):
            temporal = self._reproject(ctx, inputs, state["history"], ctx.velocity,
                                       ctx.last_velocity, gbuffer.roughness)

        # 3. spatial Poisson denoise (skipped by the *_temporal modes)
        if self.denoise_mode in ("full", "denoised"):
            with tracing.span(spans["denoise"]):
                denoised = poisson_denoise(temporal, gbuffer, ctx.frame_index,
                                           self.denoise_cfg)
        else:
            denoised = temporal
        with tracing.span(spans["compose"]):
            out, composed = self._compose(ctx, gbuffer, color,
                                          (g_diffuse, g_specular), temporal,
                                          denoised)
        return out, {"history": list(denoised), "composed": composed}

    def split_placement(self):
        """Per shard for SSGI at full resolution; whole for SSR and a
        scaled pass (whose row blocks would not line up at both
        sizes)."""
        return ("shard" if self.mode == "ssgi" and self.resolution_scale >= 1.0
                else "whole")

    def apply_split(self, sf, ctx, color, state):
        """The trace by ``ops.ssgi.ssgi_split`` (sources gathered once),
        the reprojection per shard halo-extended by its reach, the
        Poisson passes with their own halo each, the composes per
        shard."""
        u = ctx.params[self.name]
        fh = sf.height
        gbuffer = ctx.gbuffer
        gi_w = ctx.params["__global__"].get("gi_mask_meshes")
        if self.selection == "rerender" and ctx.gi_gbuffer is not None:
            gbuffer = ctx.gi_gbuffer
        elif gbuffer.mesh_id is not None and gi_w is not None and (gi_w < 0.5).any():
            gbuffer = sf.map(lambda _row0, gb: _mask_gbuffer(gb, gi_w), 0,
                             gbuffer)
        traced = ssgi_split(sf, gbuffer, ctx.velocity, state["composed"], color,
                            ctx.env, ctx.cam, ctx.frame_index, self.cfg,
                            ray_distance=u["ray_distance"],
                            thickness=u["thickness"], env_blur=u["env_blur"])
        temporal = sf.map(
            lambda row0, inputs, history, vel, last_vel, rough: self._reproject(
                ctx, inputs, history, vel, last_vel, rough, row0, fh),
            halo_rows(self.temporal_cfg), list(traced), state["history"],
            ctx.velocity, ctx.last_velocity, gbuffer.roughness)
        if self.denoise_mode in ("full", "denoised"):
            denoised = poisson_denoise_blocks(temporal, gbuffer, ctx.frame_index,
                                              self.denoise_cfg, sf.mesh,
                                              (fh, sf.width))
        else:
            denoised = temporal
        out, composed = sf.map(
            lambda row0, gb, c, tr, te, de: self._compose(ctx, gb, c, tr, te, de,
                                                           row0, fh),
            0, gbuffer, color, list(traced), temporal, denoised)
        return out, {"history": list(denoised), "composed": composed}


def _mask_gbuffer(gbuffer: GBuffer, gi_w) -> GBuffer:
    """``gbuffer`` with the pixels of the meshes whose weight in the host
    array ``gi_w`` is below 0.5 sent to background."""
    weights = tracing.to_device(gi_w, gbuffer.device, site="ssgi.gi_weights")
    mesh_id = gbuffer.mesh_id
    sel = torch.where(mesh_id >= 0, weights[mesh_id.clamp(min=0).long()],
                      1.0) > 0.5
    s1 = sel[..., None]
    return GBuffer(
        diffuse=torch.where(s1, gbuffer.diffuse, 0.0),
        normal=torch.where(s1, gbuffer.normal, 0.0),
        roughness=torch.where(sel, gbuffer.roughness, 0.0),
        metalness=torch.where(sel, gbuffer.metalness, 0.0),
        emissive=torch.where(s1, gbuffer.emissive, 0.0),
        depth=torch.where(sel, gbuffer.depth, 1.0),
        mesh_id=torch.where(sel, mesh_id, -1),
        ao=None if gbuffer.ao is None else torch.where(sel, gbuffer.ao, 1.0))


class SSREffect(SSGIEffect):
    """Specular-only screen-space reflections (`SSREffect.js:3-9`)."""

    name = "ssr"
    mode = "ssr"
