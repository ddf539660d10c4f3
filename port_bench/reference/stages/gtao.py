"""GTAO (upstream `gtao.frag:77-125`, with `hbao_utils.glsl`), per pixel
at the defaults of the port's ``GTAOEffect`` (16 samples, distance 2,
animated noise, G-buffer normals for the denoiser), then `AOEffect.js`'s
Poisson denoise and compose (``hbao.py``'s :func:`denoise_compose`).

For each pixel: its depth-derived normal (the 9-tap stencil of
`hbao_utils.glsl:46-68`: at each side the neighbour whose depth lies
nearer the line through the centre and the next, the world positions at
the texel's continuous uv one texel over) and its world position; for
sample i of 16, the point (vogel_i + 1) / 2 of the 16-point table
(`gtao.frag:69-75`) as a cosine-weighted direction about that normal
(`hbao_utils.glsl:84-93`), the sample 4 * noise.r * radius along it,
radius 0.25 * distance / 2, noise the frame's blue noise at index 16
frame + i; the sample projected to the screen and its depth read
nearest, and the 9-tap normal at that texel; the occlusion
``smoothstep(0, 1, 1 - max(viewZ - sampleViewZ, 0)^4)`` times the dot
of the two normals, summed, over 16, clamped to [0, 1]; 1 on the
background.

Departures from the shader, as the port states them: a fetch outside the
frame reads its edge texel (GLSL leaves it undefined); a sample whose
clip w is within 1e-8 of 0 divides by 1e-8."""

from __future__ import annotations

import torch

from .common import (blue_noise, cosine_hemisphere, dot, normalize, project, proj_view,
                     screen_to_world, to_index, uv_grid, view_z)
from .hbao import denoise_compose

#: `gtao.frag:69-75`
VOGEL16 = ((0.030909661398755346, -0.35219964910859053),
           (0.24815307104280765, 0.7911510938702059),
           (-0.18434221951957994, 0.16887257356538096),
           (0.47167354889397395, -0.30004010277588555),
           (0.2634617551286817, 0.3436392055405124),
           (-0.12442994035028206, -0.9602172618446438),
           (-0.49235674265771434, -0.08709097518965582),
           (-0.15897452050963823, 0.5913772922836407),
           (-0.6932591671033536, 0.2861673063562022),
           (0.0, 0.0),
           (0.6642004583437224, 0.24256494210002652),
           (-0.5379843192229464, 0.7652273337186949),
           (0.8803636453299621, -0.19354547781165166),
           (0.33507968037296143, -0.7160458140378687),
           (-0.30486134122856906, -0.586991961294461),
           (-0.7492948872853635, -0.4342317029973909))
DISTANCE = 2.0


def depth_normal(depth, iy, ix, uv, cam):
    """`hbao_utils.glsl:46-68`: the world normal from the depth stencil
    about texel (iy, ix), clamped to the frame, the world positions at
    ``uv`` and one texel either side of it."""
    h, w = depth.shape
    tap = lambda dy, dx: depth[(iy + dy).clamp(0, h - 1), (ix + dx).clamp(0, w - 1)]
    c0 = tap(0, 0)
    l1, l2, r1, r2 = tap(0, -1), tap(0, -2), tap(0, 1), tap(0, 2)
    b1, b2, t1, t2 = tap(-1, 0), tap(-2, 0), tap(1, 0), tap(2, 0)
    at = lambda d, du, dv: screen_to_world(
        torch.stack([uv[..., 0] + du, uv[..., 1] + dv], -1), d, cam)
    ce = at(c0, 0.0, 0.0)
    dpdx = torch.where(((2.0 * l1 - l2 - c0).abs() < (2.0 * r1 - r2 - c0).abs())[..., None],
                       ce - at(l1, -1.0 / w, 0.0), at(r1, 1.0 / w, 0.0) - ce)
    dpdy = torch.where(((2.0 * b1 - b2 - c0).abs() < (2.0 * t1 - t2 - c0).abs())[..., None],
                       ce - at(b1, 0.0, -1.0 / h), at(t1, 0.0, 1.0 / h) - ce)
    return normalize(torch.linalg.cross(dpdx, dpdy)), c0


def gtao(depth, cam, frame: int):
    h, w = depth.shape
    dev = depth.device
    uv = uv_grid(h, w, dev)
    ys = torch.arange(h, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, device=dev)[None, :].expand(h, w)
    normal, _ = depth_normal(depth, ys, xs, uv, cam)
    pos = screen_to_world(uv, depth, cam)
    vz = view_z(depth, cam).abs()
    pv = proj_view(cam)
    radius = 0.25 * DISTANCE / 2.0
    acc = torch.zeros_like(depth)
    for i, (vx, vy) in enumerate(VOGEL16):
        noise = blue_noise(h, w, frame * len(VOGEL16) + i, dev)
        u = torch.tensor([vx * 0.5 + 0.5, vy * 0.5 + 0.5], device=dev).expand(h, w, 2)
        d = cosine_hemisphere(normal, u)
        p = pos + (4.0 * noise[..., 0] * radius)[..., None] * d
        clip, cw = project(pv, p)
        cw = torch.where(cw.abs() > 1e-8, cw, 1e-8)
        suv = clip[..., :2] / cw[..., None] * 0.5 + 0.5
        iy = to_index(suv[..., 1] * h).clamp(0, h - 1)
        ix = to_index(suv[..., 0] * w).clamp(0, w - 1)
        s_normal, s_depth = depth_normal(depth, iy, ix, suv, cam)
        dz = torch.clamp(vz - view_z(s_depth, cam).abs(), min=0.0)
        t = torch.clamp(1.0 - dz * dz * dz * dz, 0.0, 1.0)
        acc = acc + t * t * (3.0 - 2.0 * t) * dot(normal, s_normal)
    a = torch.clamp(acc / float(len(VOGEL16)), 0.0, 1.0)
    return torch.where(depth >= 1.0, 1.0, a)


def _refuse_options(effect):
    cfg, dn = effect.cfg, effect.denoise_cfg
    given = dict(spp=cfg.spp, distance=cfg.distance, animated_noise=cfg.animated_noise,
                 resolution_scale=effect.resolution_scale, color=effect.color,
                 iterations=dn.iterations, radius=dn.radius, phi=dn.phi, luma_phi=dn.luma_phi,
                 depth_phi=dn.depth_phi, normal_phi=dn.normal_phi)
    want = dict(spp=16, distance=DISTANCE, animated_noise=True, resolution_scale=1.0,
                color=(0.0, 0.0, 0.0), iterations=1, radius=3.0, phi=0.5, luma_phi=5.0,
                depth_phi=2.0, normal_phi=3.25)
    other = {k: given[k] for k, v in want.items() if given[k] != v}
    if other:
        raise NotImplementedError(f"the GTAO reference follows no {other}")


def step(rec):
    _refuse_options(rec["effect"])
    ctx = rec["ctx"]
    return denoise_compose(rec, gtao(ctx.gbuffer.depth, ctx.unjittered_cam, ctx.frame_index))
