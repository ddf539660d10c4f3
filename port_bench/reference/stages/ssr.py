"""SSR after its trace (upstream `SSREffect.js:3-9`, `Denoiser.js`,
`denoiser_compose.frag` in its specular mode, `ssgi_compose.frag`), per
pixel: the trace's specular texture (the record's ``trace``, taken as
given) as the one slot of the temporal reprojection with the options
`SSREffect`'s denoiser passes (`Denoiser.js:33-42`: log colour, the slot
reprojected by its hit point, the G-buffer's roughness, confidence power
0.75, max blend 1, clamp intensity 0.5, full accumulation while the
camera stands still) on the jittered camera; the Poisson denoiser with
that one RGBA slot, weighted by the surface's gloss (normal, roughness
and specular phi 50); the composition, the scene colour plus F times
the specular GI plus the emissive (F as in ``ssgi.py``; the background
keeps the denoised texture); and the compose over the scene where the
depth is in front of 1. The new state: the denoised texture and the
composition."""

from __future__ import annotations

import torch

from .poisson import denoise
from .ssgi import DENOISE, fresnel
from .temporal import reproject


def compose_ssr(specular_gi, color, gb, cam):
    """`denoiser_compose.frag` with a specular input and the scene colour
    as its diffuse part; the background keeps the specular input."""
    gi = color + specular_gi[..., :3] * fresnel(gb, cam) + gb.emissive
    return torch.where((gb.depth >= 1.0)[..., None], specular_gi[..., :3], gi)


def _refuse_options(effect):
    cfg = effect.denoise_cfg
    given = dict(denoise_mode=effect.denoise_mode, output_texture=effect.output_texture,
                 fog_density=effect.fog_density, resolution_scale=effect.resolution_scale,
                 iterations=cfg.iterations, **{k: getattr(cfg, k) for k in DENOISE})
    want = dict(denoise_mode="full", output_texture=None, fog_density=0.0,
                resolution_scale=1.0, iterations=1, **DENOISE)
    other = {k: given[k] for k, v in want.items() if given[k] != v}
    if other:
        raise NotImplementedError(f"the SSR reference follows no {other}")


def step(rec):
    ctx, color, state = rec["ctx"], rec["color"], rec["state"]
    _refuse_options(rec["effect"])
    gb, g = ctx.gbuffer, ctx.params["__global__"]
    mask = g.get("gi_mask_meshes")
    if mask is not None and (torch.as_tensor(mask) < 0.5).any():
        raise NotImplementedError("a G-buffer with meshes left out of the GI")
    (temporal,) = reproject([rec["trace"][1]], state["history"], ctx.velocity,
                            ctx.last_velocity, ctx.cam, ctx.prev_cam, log=True,
                            specular=(True,), power=0.75, input_type="specular",
                            max_blend=1.0, clamp_intensity=0.5,
                            full_accumulate=not g["camera_moved"], keep_data=g["keep_data"],
                            roughness=gb.roughness)
    (den,) = denoise([temporal], gb, ctx.frame_index, DENOISE, (True,))
    composed = compose_ssr(den, color, gb, ctx.cam)
    out = torch.where((gb.depth >= 1.0)[..., None], color, composed)
    return out, {"history": [den], "composed": composed}
