"""HBAO (upstream `HBAOEffect.js`, `hbao.frag`, `hbao_utils.glsl`, and
`AOEffect.js`'s pass -> Poisson denoise -> compose), per pixel at the
defaults (8 samples, distance 2, distance power 1, bias 40, thickness
0.075, G-buffer normals, animated noise), with the JAX package's window:
a sample's depth is read nearest within +-32 rows and +-32 columns of
the pixel (``ops/ao.py``). Then the AO through the denoiser (normal phi
3.25) and ``color * ao^power`` where the depth is in front of 0.9999
(`ao_compose.frag`)."""

from __future__ import annotations

import torch

from .common import (blue_noise, band_row, cosine_hemisphere, dot, project, proj_view,
                     screen_to_world, to_index, uv_grid, window_rows_cols)
from .poisson import denoise

SPP, DISTANCE, POW, BIAS, THICKNESS, WINDOW = 8, 2.0, 1.0, 40.0, 0.075, 32
DENOISE = dict(radius=3.0, phi=0.5, luma_phi=5.0, depth_phi=2.0, normal_phi=3.25,
               roughness_phi=50.0, specular_phi=50.0)


def ao(depth, normal, cam, frame: int):
    h, w = depth.shape
    dev = depth.device
    pos = screen_to_world(uv_grid(h, w, dev), depth, cam)
    cam_pos = torch.as_tensor(cam.position, device=dev)
    pv = proj_view(cam)
    acc = torch.zeros_like(depth)
    total = torch.zeros_like(depth)
    th = THICKNESS * 0.01
    for i in range(SPP):
        noise = blue_noise(h, w, frame * SPP + i, dev)
        d = cosine_hemisphere(normal, noise[..., :2])
        p = pos + (DISTANCE * noise[..., 2] ** (POW + 1.0))[..., None] * d
        clip, cw = project(pv, p)
        cw = torch.where(cw.abs() > 1e-8, cw, 1e-8)
        suv = clip[..., :2] / cw[..., None] * 0.5 + 0.5
        iy, ix = to_index(suv[..., 1] * h), to_index(suv[..., 0] * w)
        ys, dyc, _, col = window_rows_cols(iy, ix, h, w, WINDOW, WINDOW)
        sd = depth[band_row(ys, dyc, 0, h, WINDOW, 0, 0), col(0)]
        dist = torch.linalg.vector_norm(p - cam_pos, dim=-1)
        dd = (depth - sd) * 0.001 * dist * dist
        cos = dot(normal, d)
        total = total + cos
        occ = torch.clamp(sd + dd * BIAS * 1000.0 - depth, min=0.0) * cos
        m = torch.clamp(1.0 - dd / th, min=0.0)
        occ = torch.sqrt(torch.clamp(10.0 * occ * m / torch.clamp(dist, min=1e-6), min=0.0))
        acc = acc + torch.where(dd < th, occ, 0.0)
    a = torch.where(total > 0.0, acc / total, acc)
    a = torch.clamp(1.0 - a, 0.0, 1.0)
    return torch.where(depth >= 1.0, 1.0, a)


def denoise_compose(rec, a):
    """`AOEffect.js`'s pass after the AO ``a``: the Poisson denoise of the
    AO slot with the G-buffer's normals (normal phi 3.25), then
    ``color * ao^power`` where the depth is in front of 0.9999
    (`ao_compose.frag`; the default black AO colour)."""
    ctx, color = rec["ctx"], rec["color"]
    gb = ctx.gbuffer
    tex = torch.cat([a[..., None].expand(*a.shape, 3), torch.zeros_like(a)[..., None]], -1)
    (d,) = denoise([tex], gb, ctx.frame_index, DENOISE, (False,))
    a = torch.clamp(d[..., 0], 0.0, 1.0)
    a = torch.where(gb.depth > 0.9999, 1.0, a) ** ctx.params[rec["effect"].name]["power"]
    return color * a[..., None], rec["state"]


def step(rec):
    ctx = rec["ctx"]
    gb = ctx.gbuffer
    return denoise_compose(rec, ao(gb.depth, gb.normal, ctx.unjittered_cam, ctx.frame_index))
