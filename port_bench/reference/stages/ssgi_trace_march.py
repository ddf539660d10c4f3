"""The SSGI trace in march mode, per pixel: upstream's `ssgi.frag` sample
with its own RayMarch and BinarySearch (`ssgi.frag:441-503`), as the
JAX package's ``_view_space_ray_march`` (``ops/ssgi.py``) defines them.

Each pixel draws its rays as the sweep module does (a GGX-VNDF specular
ray, a cosine diffuse ray, an environment importance sample chosen
against roughness) and weights them with the same Disney BRDFs, MIS,
environment fallback with its luminance clamp, border fade and direct
light. Each ray then takes ``steps - 1`` steps of ``l * distance /
steps`` from the pixel's view position, step ``i`` eased by ``1 -
exp(-0.25 (i + b - 0.5)^2)`` (``b`` the pixel's third noise channel);
it hits at the first step whose nearest depth texel lies in [0,
thickness) behind it, and ``refine_steps`` bisections from half a step
back refine the hit. The hit's radiance is the previous frame's
composition (a float16 texture, bilinear) read at the hit's uv less the
velocity at the hit (nearest), where that lies in the frame. A missed
ray keeps the 1e9 sentinel as its hit position.

Where the march mode differs from the sweep module, this follows the
march: the environment's importance sample walks the exact marginal ->
conditional -> colour chain (bilinear fetches of ``env.marginal``,
``env.conditional`` and the float16 map), not the precomposed table;
the fallback is fetched for every pixel by its own direction, trilinear
between the two mip levels about its lod, not once per 2 x 2 quad at the
nearest level.

Departures from the frozen copy's ``view_space_ray_march`` and
``_shade`` (``reference/port/ops/ssgi.py``), none of which changes a
value it produces: a lane keeps the uv of its hit step alone (the copy
carries the last step's uv on missed lanes, which only the border fade
of a missed ray, whose radiance is the environment's, would read); and
options the flagship stack leaves at their defaults (``missed_rays``,
``env_box``, a ``resolution_scale`` below 1, SSR's single ray) are
refused rather than followed. ``steps`` and ``refine_steps`` are the
effect's own; the environment's mip levels and inverse-CDF lookups
(``ctx.env``) are taken as given inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import (bilinear, equirect_uv, half, luminance, normalize, project, rotate_t,
                     to_index, view_z)
from .ssgi_trace import (EPS, _equirect_dir, choose_rays, pack, refuse_options, sample,
                         shade)


def _bilinear2(tex, uv):
    """:func:`bilinear` of a one-channel (H, W) texture."""
    return bilinear(tex[..., None], uv)[..., 0]


def _screen(p, pos):
    """`ssgi_utils.frag:26-33`: a view position's screen uv."""
    xyz, w = project(p, pos)
    return xyz[..., :2] / w[..., None] * 0.5 + 0.5


def _nearest(tex, uv):
    """NearestFilter fetch, clamped to the frame."""
    h, w = tex.shape[0], tex.shape[1]
    iy = to_index(uv[..., 1] * h).clamp(0, h - 1)
    ix = to_index(uv[..., 0] * w).clamp(0, w - 1)
    return tex[iy, ix]


def _march(view_pos, l, depth, cam, b, thickness, ray_distance, steps, refine):
    """(uv, hit position or 1e9, missed) of RayMarch + BinarySearch."""
    p = np.asarray(cam.projection_matrix, np.float32)
    step_dir = l * (ray_distance / float(steps))
    hit = torch.zeros(view_pos.shape[:-1], dtype=torch.bool, device=view_pos.device)
    pos = view_pos
    uv = _screen(p, view_pos)
    for i in range(1, steps):
        x = float(i) + b - 0.5
        cur = torch.where(hit[..., None], pos,
                          pos + step_dir * (1.0 - torch.exp(-0.25 * (x * x)))[..., None])
        cur_uv = _screen(p, cur)
        diff = view_z(_nearest(depth, cur_uv), cam) - cur[..., 2]
        new = (~hit) & (diff >= 0.0) & (diff < thickness)
        uv = torch.where(new[..., None], cur_uv, uv)
        hit = hit | new
        pos = cur
    if refine > 0:
        bdir = (step_dir * 0.5).expand_as(pos)
        bpos = pos - bdir
        for _ in range(refine):
            diff = view_z(_nearest(depth, _screen(p, bpos)), cam) - bpos[..., 2]
            bdir = bdir * 0.5
            bpos = bpos + torch.where((diff >= 0.0)[..., None], -bdir, bdir)
        uv = torch.where(hit[..., None], _screen(p, bpos), uv)
        pos = torch.where(hit[..., None], bpos, pos)
    return uv, torch.where(hit[..., None], pos, 1.0e9), ~hit


def _env_color(env, l, cam, rough, is_diffuse, is_env, env_blur):
    """`ssgi.frag:311-346`, per pixel, trilinear in the mip chain."""
    mips = [m.float() for m in env.mips]
    top = len(mips) - 1
    uv = equirect_uv(normalize(rotate_t(cam.view_matrix, l)))
    lod = env_blur * top * torch.where((~is_diffuse) & (rough < 0.15), rough / 0.15, 1.0)
    lod = torch.clamp(lod, 0.0, float(top))
    l0 = torch.floor(lod)
    lo = hi = torch.zeros(uv.shape[:-1] + (3,), device=uv.device)
    for k, m in enumerate(mips):
        tap = bilinear(m, uv)
        lo = torch.where((l0 == k)[..., None], tap, lo)
        hi = torch.where((torch.clamp(l0 + 1.0, max=float(top)) == k)[..., None], tap, hi)
    out = lo + (hi - lo) * (lod - l0)[..., None]
    cap = torch.where(is_env, 100.0, 25.0)
    lum = luminance(out)
    return out * torch.where(lum > cap, cap / torch.clamp(lum, min=EPS), 1.0)[..., None]


def step(rec):
    ctx, color, state = rec["ctx"], rec["color"], rec["state"]
    cfg = rec["effect"].cfg
    refuse_options(rec["effect"], mode="ssgi", trace="march", sweep_dirs=cfg.sweep_dirs,
                   sweep_steps=cfg.sweep_steps, env_fetch_stride=cfg.env_fetch_stride)
    u = ctx.params["ssgi"]
    cam, env = ctx.cam, ctx.env
    s = sample(ctx, ssr=False)
    r1, r2 = s["r1"], s["r2"]
    # environment importance sample, the exact inverse-CDF chain
    # (`ssgi_utils.frag:210-225`)
    eh, ew = env.mips[0].shape[0], env.mips[0].shape[1]
    env_v = _bilinear2(env.marginal[:, None], torch.stack([torch.zeros_like(r1), r1], -1))
    env_u = _bilinear2(env.conditional, torch.stack([r2, env_v], -1))
    env_uv = torch.stack([env_u, env_v], -1)
    env_pdf = (ew * eh) * (luminance(bilinear(env.mips[0].float(), env_uv))
                           / float(env.total_sum))
    env_dir = normalize(rotate_t(cam.camera_matrix_world, _equirect_dir(env_uv)))
    rays = choose_rays(s, env_pdf, env_dir)
    acc = half(state["composed"][..., :3])
    vel = ctx.velocity.velocity
    out = []
    for l in rays:
        c_uv, pos, missed = _march(s["view_pos"], l, s["depth"], cam, s["r3"], u["thickness"],
                                   u["ray_distance"], int(cfg.steps), int(cfg.refine_steps))
        env_c = _env_color(env, l, cam, s["rough"], s["is_diffuse"], s["is_env"],
                           u["env_blur"])
        # the velocity at the hit (NearestFilter), then the previous
        # frame's composition there (a float16 LinearFilter target)
        r_uv = c_uv - _nearest(vel, c_uv)
        inside = ((r_uv[..., 0] >= 0.0) & (r_uv[..., 0] <= 1.0)
                  & (r_uv[..., 1] >= 0.0) & (r_uv[..., 1] <= 1.0))
        out.append((shade(s, l, c_uv, missed, env_c, bilinear(acc, r_uv), inside), pos))
    return pack(s, color, cam, out)
