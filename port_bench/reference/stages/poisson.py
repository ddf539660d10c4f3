"""The Poisson denoiser, per pixel: upstream's `poisson_denoise.frag`
(8 Poisson taps rotated by the blue noise and scaled by the radius and
the surface's flatness; normal, depth, roughness and luma edge-stopping;
disocclusion-age blending) on its packed storage, as the JAX package's
``ops/poisson_denoise.py`` states it: float16 textures, normals through
the octahedral half2x16 code (a zero normal stays zero at the centre),
every tap NearestFilter at the frame-clamped texel; ``2 * iterations``
passes, pass p of frame f on noise index 2 f + p (one iteration)."""

from __future__ import annotations

import math

import torch

from .common import blue_noise, decode_oct, encode_oct, fwidth, half, luminance, mix, uv_grid

S = 0.25 * math.sqrt(2.0)
TAPS = ((-1.0, 0.0), (0.0, -1.0), (1.0, 0.0), (0.0, 1.0),
        (-S, -S), (S, -S), (S, S), (-S, S))


def _lum8(rgb):
    return torch.clamp(luminance(rgb), min=0.0) ** 0.125


def denoise_pass(textures, gb, index: int, cfg: dict, specular):
    depth, rough = gb.depth, gb.roughness
    h, w = depth.shape
    dev = depth.device
    valid = gb.normal.abs().sum(-1, keepdim=True) > 1e-8
    code = torch.where(valid, half(encode_oct(torch.where(valid, gb.normal, 1.0))), 0.0)
    normal = torch.where(valid, decode_oct(code), 0.0)
    tap_normal = decode_oct(code)  # a background tap's weight is 0 whatever it reads
    textures = [half(t) for t in textures]
    gloss = torch.clamp(4.0 * (1.0 - rough / 0.25), min=0.0)
    spec_factor = torch.exp(-gloss * cfg["specular_phi"])
    flat = 1.0 - torch.clamp(torch.linalg.vector_norm(fwidth(normal), dim=-1), max=1.0)
    flat = flat ** 2.0 * 0.75 + 0.25
    angle = blue_noise(h, w, index, dev)[..., 0] * 2.0 * math.pi
    s, c = torch.sin(angle), torch.cos(angle)
    scale = cfg["radius"] * flat
    uv = uv_grid(h, w, dev)
    centers = []
    for t in textures:
        rgb = torch.log(t[..., :3] * 1.0003 + 1.0)
        centers.append(dict(lum=_lum8(rgb), age=1.0 / (t[..., 3] + 1.0) ** (1.2 * cfg["phi"]),
                            acc=rgb, total=torch.ones_like(depth)))
    for ox, oy in TAPS:
        # GLSL's column-major mat2(c, -s, s, c) on the aspect-scaled offset
        tu = uv[..., 0] + (c * (ox / w) + s * (oy / h)) * scale
        tv = uv[..., 1] + (-s * (ox / w) + c * (oy / h)) * scale
        ix = torch.floor(tu * w).to(torch.int64).clamp(0, w - 1)
        iy = torch.floor(tv * h).to(torch.int64).clamp(0, h - 1)
        n_depth = depth[iy, ix]
        nd = 1.0 - torch.clamp((normal * tap_normal[iy, ix]).sum(-1), min=0.0)
        wb = torch.exp(-nd * cfg["normal_phi"] - 10000.0 * (depth - n_depth).abs()
                       * cfg["depth_phi"] - (rough - rough[iy, ix]).abs() * cfg["roughness_phi"])
        wb = torch.where(n_depth >= 1.0, 0.0, wb)
        for i, t in enumerate(textures):
            wt = wb * spec_factor if specular[i] else wb
            rgb = torch.log(torch.clamp(t[iy, ix][..., :3], min=0.0) + 1.0)
            ce = centers[i]
            luma = torch.exp(-torch.clamp((ce["lum"] - _lum8(rgb)).abs(), max=0.5)
                             * cfg["luma_phi"])
            wt = mix(wt * luma, torch.clamp(wt, min=1e-20) ** 0.1, ce["age"]) * ce["age"]
            wt = wt * (wt >= 0.0001)
            ce["acc"] = ce["acc"] + wt[..., None] * rgb
            ce["total"] = ce["total"] + wt
    out = []
    for t, ce in zip(textures, centers):
        rgb = torch.exp(ce["acc"] / ce["total"][..., None]) - 1.0
        o = torch.cat([rgb, t[..., 3:4]], -1)
        out.append(torch.where((depth >= 1.0)[..., None], t, o))
    return out


def denoise(textures, gb, frame: int, cfg: dict, specular):
    out = list(textures)
    for p in range(2):
        out = denoise_pass(out, gb, frame * 2 + p, cfg, specular)
    return out
