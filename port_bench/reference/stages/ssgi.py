"""SSGI after its trace (upstream `SSGIEffect.js`, `Denoiser.js`,
`denoiser_compose.frag` with `denoiser_compose_functions.glsl`,
`ssgi_compose.frag`), per pixel: the trace's diffuse and specular
textures (the record's ``trace``, taken as given) through the temporal
reprojection (`Denoiser.js:33-42`: log colour, the specular slot by its
hit point, confidence power 0.75, max blend 1, clamp intensity 0.5, full
accumulation while the camera stands still) on the jittered camera, the
Poisson denoiser (normal, roughness and specular phi 50; the specular
slot weighted by the surface's gloss), the GI composition (diffuse *
(1 - metalness) * (1 - F) * diffuse GI + F * specular GI + emissive,
F the Schlick Fresnel of a GGX half vector drawn at (0.25, 0.25)), and
the compose over the scene where the depth is in front of 1. The new
state: the denoised textures and the composition."""

from __future__ import annotations

import torch

from .common import dot, ggx_vndf, mix, normalize, onb, rotate_t, uv_grid, view_z
from .poisson import denoise
from .temporal import reproject

DENOISE = dict(radius=3.0, phi=0.5, luma_phi=5.0, depth_phi=2.0, normal_phi=50.0,
               roughness_phi=50.0, specular_phi=50.0)


def fresnel(gb, cam):
    """`denoiser_compose_functions.glsl`'s accumulated Fresnel: Schlick's
    F of the half vector of a GGX-VNDF sample at (0.25, 0.25) about the
    squared roughness, mirrored into the normal's hemisphere."""
    depth = gb.depth
    h, w = depth.shape
    uv = uv_grid(h, w, depth.device)
    rough = gb.roughness * gb.roughness
    metal, albedo = gb.metalness, gb.diffuse[..., :3]
    vz = view_z(depth, cam)
    p = cam.projection_matrix
    pi = cam.projection_matrix_inverse
    cw = float(p[3, 2]) * vz + float(p[3, 3])
    cx, cy = (uv[..., 0] - 0.5) * 2.0 * cw, (uv[..., 1] - 0.5) * 2.0 * cw
    cz = (vz - 0.5) * 2.0 * cw
    vx = float(pi[0, 0]) * cx + float(pi[0, 1]) * cy + float(pi[0, 2]) * cz + float(pi[0, 3]) * cw
    vy = float(pi[1, 0]) * cx + float(pi[1, 1]) * cy + float(pi[1, 2]) * cz + float(pi[1, 3]) * cw
    v_view = -normalize(torch.stack([vx, vy, vz], -1))
    n = gb.normal
    v_world = rotate_t(cam.view_matrix, v_view)
    t, b = onb(n)
    v_loc = torch.stack([dot(v_world, t), dot(v_world, b), dot(v_world, n)], -1)
    quarter = torch.full_like(rough, 0.25)
    hl = ggx_vndf(v_loc, rough, quarter, quarter)
    hl = torch.where(hl[..., 2:3] < 0.0, -hl, hl)
    i = -v_loc
    l_loc = normalize(i - 2.0 * dot(hl, i)[..., None] * hl)
    l_world = l_loc[..., 0:1] * t + l_loc[..., 1:2] * b + l_loc[..., 2:3] * n
    l_view = normalize(rotate_t(cam.camera_matrix_world, l_world))
    n_view = normalize(rotate_t(cam.camera_matrix_world, n))
    l_view = torch.where((dot(n_view, l_view) < 0.0)[..., None], -l_view, l_view)
    hv = normalize(v_view + l_view)
    voh = torch.clamp(dot(v_view, hv), min=1e-5)
    f0 = mix(torch.full_like(albedo, 0.04), albedo, metal[..., None])
    return f0 + (1.0 - f0) * ((1.0 - voh) ** 5.0)[..., None]


def compose_gi(diffuse_gi, specular_gi, gb, cam):
    """`denoiser_compose.frag`; the background keeps the diffuse input."""
    fres = fresnel(gb, cam)
    metal, albedo = gb.metalness, gb.diffuse[..., :3]
    gi = (albedo * (1.0 - metal[..., None]) * (1.0 - fres) * diffuse_gi[..., :3]
          + specular_gi[..., :3] * fres + gb.emissive)
    return torch.where((gb.depth >= 1.0)[..., None], diffuse_gi[..., :3], gi)


def step(rec):
    ctx, color, state = rec["ctx"], rec["color"], rec["state"]
    gb, g = ctx.gbuffer, ctx.params["__global__"]
    mask = g.get("gi_mask_meshes")
    if mask is not None and (torch.as_tensor(mask) < 0.5).any():
        raise NotImplementedError("a G-buffer with meshes left out of the GI")
    temporal = reproject(list(rec["trace"]), state["history"], ctx.velocity,
                         ctx.last_velocity, ctx.cam, ctx.prev_cam, log=True,
                         specular=(False, True), power=0.75, input_type="diffuse_specular",
                         max_blend=1.0, clamp_intensity=0.5,
                         full_accumulate=not g["camera_moved"], keep_data=g["keep_data"])
    den = denoise(temporal, gb, ctx.frame_index, DENOISE, (False, True))
    composed = compose_gi(den[0], den[1], gb, ctx.cam)
    out = torch.where((gb.depth >= 1.0)[..., None], color, composed)
    return out, {"history": den, "composed": composed}
