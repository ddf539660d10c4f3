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

import math

import numpy as np
import torch

from .common import (bilinear, blue_noise, cosine_hemisphere, dot, equirect_uv, ggx_vndf,
                     half, luminance, mix, normalize, onb, point, project, rotate_t,
                     to_index, uv_grid, view_z)
from .ssgi_trace import EPS, _angles, _d_gtr, _equirect_dir, _smith_g, _smoothstep


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


def _refuse_options(effect):
    cfg = effect.cfg
    given = dict(mode=cfg.mode, missed_rays=cfg.missed_rays,
                 importance_sampling=cfg.importance_sampling, env_lum_clamp=cfg.env_lum_clamp,
                 use_direct_light=cfg.use_direct_light, env_box=cfg.env_box,
                 resolution_scale=effect.resolution_scale)
    followed = dict(mode="ssgi", missed_rays=False, importance_sampling=True,
                    env_lum_clamp=True, use_direct_light=True, env_box=None,
                    resolution_scale=1.0)
    other = {k: v for k, v in given.items() if v != followed[k]}
    if other:
        raise NotImplementedError(f"the march reference follows no {other}")


def step(rec):
    ctx, color, state = rec["ctx"], rec["color"], rec["state"]
    _refuse_options(rec["effect"])
    cfg = rec["effect"].cfg
    u = ctx.params["ssgi"]
    gb, cam, env, frame = ctx.gbuffer, ctx.cam, ctx.env, ctx.frame_index
    depth, rough, metal = gb.depth, gb.roughness, gb.metalness
    albedo = gb.diffuse[..., :3]
    h, w = depth.shape
    dev = depth.device
    uv = uv_grid(h, w, dev)
    r_sq = torch.clamp(rough * rough, 1e-6, 1.0)
    vz = view_z(depth, cam)
    p, pi = cam.projection_matrix, cam.projection_matrix_inverse
    cw = float(p[3, 2]) * vz + float(p[3, 3])
    cx, cy = (uv[..., 0] - 0.5) * 2.0 * cw, (uv[..., 1] - 0.5) * 2.0 * cw
    cz = (vz - 0.5) * 2.0 * cw
    view_pos = torch.stack([
        float(pi[0, 0]) * cx + float(pi[0, 1]) * cy + float(pi[0, 2]) * cz + float(pi[0, 3]) * cw,
        float(pi[1, 0]) * cx + float(pi[1, 1]) * cy + float(pi[1, 2]) * cz + float(pi[1, 3]) * cw,
        vz], -1)
    n_world = gb.normal
    n = normalize(rotate_t(cam.camera_matrix_world, n_world))
    v = -normalize(view_pos)
    nov = torch.clamp(dot(n, v), min=EPS)
    t_w, b_w = onb(n_world)
    v_world = rotate_t(cam.view_matrix, v)
    v_loc = torch.stack([dot(v_world, t_w), dot(v_world, b_w), dot(v_world, n_world)], -1)
    f0 = mix(torch.full_like(albedo, 0.04), albedo, metal[..., None])
    r1, r2, r3, r4 = blue_noise(h, w, frame, dev).unbind(-1)
    hl = ggx_vndf(v_loc, r_sq, r1, r2)
    hl = torch.where(hl[..., 2:3] < 0.0, -hl, hl)
    i = -v_loc
    l_loc = normalize(i - 2.0 * dot(hl, i)[..., None] * hl)
    l_world = l_loc[..., 0:1] * t_w + l_loc[..., 1:2] * b_w + l_loc[..., 2:3] * n_world
    l_view = normalize(rotate_t(cam.camera_matrix_world, l_world))
    voh = _angles(l_view, v, n)[3]
    fres = f0 + (1.0 - f0) * ((1.0 - voh) ** 5.0)[..., None]
    diff_w = torch.clamp((1.0 - metal) * luminance(albedo), min=EPS)
    spec_w = torch.clamp(luminance(fres), min=EPS)
    is_diffuse = r3 < diff_w * (1.0 / (diff_w + spec_w))
    # environment importance sample, the exact inverse-CDF chain
    # (`ssgi_utils.frag:210-225`)
    eh, ew = env.mips[0].shape[0], env.mips[0].shape[1]
    env_v = _bilinear2(env.marginal[:, None], torch.stack([torch.zeros_like(r1), r1], -1))
    env_u = _bilinear2(env.conditional, torch.stack([r2, env_v], -1))
    env_uv = torch.stack([env_u, env_v], -1)
    env_pdf = (ew * eh) * (luminance(bilinear(env.mips[0].float(), env_uv))
                           / float(env.total_sum))
    env_dir = normalize(rotate_t(cam.camera_matrix_world, _equirect_dir(env_uv)))
    prob = torch.clamp(dot(env_dir, n) * rough, max=1.0 - EPS)
    is_env = r4 < prob
    ems_pdf = torch.clamp(torch.where(is_env, env_pdf / torch.clamp(1.0 - prob, min=EPS),
                                      1.0 - prob), min=EPS)
    cos_hemi = cosine_hemisphere(n, torch.stack([r1, r2], -1))
    rays = [torch.where(is_env[..., None], env_dir, l_view),
            torch.where(is_env[..., None], env_dir, cos_hemi)]
    acc = half(state["composed"][..., :3])
    vel = ctx.velocity.velocity
    sat_mx, sat_mn = albedo.max(-1).values, albedo.min(-1).values
    sat = torch.where(sat_mx == sat_mn, 0.0, (sat_mx - sat_mn) / torch.clamp(sat_mx, min=EPS))
    desat = (1.0 - rough) * sat * 0.4
    out = []
    for l in rays:
        c_uv, pos, missed = _march(view_pos, l, depth, cam, r3, u["thickness"],
                                   u["ray_distance"], int(cfg.steps), int(cfg.refine_steps))
        nol, noh, loh, _ = _angles(l, v, n)
        cos_t = torch.clamp(dot(n, l), min=0.0)
        fd90 = 0.5 + 2.0 * r_sq * loh ** 2.0
        f_l = 1.0 + (fd90 - 1.0) * (1.0 - nol) ** 5.0
        f_v = 1.0 + (fd90 - 1.0) * (1.0 - nov) ** 5.0
        d_brdf = (f_l * f_v / math.pi) * (1.0 - metal)
        g = _smith_g(nov, ((0.5 + r_sq * 0.5) ** 2.0) ** 2.0) * \
            _smith_g(nol, ((0.5 + r_sq * 0.5) ** 2.0) ** 2.0)
        s_brdf = _d_gtr(r_sq, noh) * g / (4.0 * nol * nov)
        s_pdf = _d_gtr(r_sq, noh) * _smith_g(nov, r_sq * r_sq) / torch.clamp(4.0 * nov, min=1e-5)
        bsdf = torch.where(is_diffuse, d_brdf, s_brdf) * cos_t
        pdf = torch.clamp(torch.where(is_diffuse, nol / math.pi, s_pdf), min=EPS)
        env_c = _env_color(env, l, cam, rough, is_diffuse, is_env, u["env_blur"])
        # the velocity at the hit (NearestFilter), then the previous
        # frame's composition there (a float16 LinearFilter target)
        r_uv = c_uv - _nearest(vel, c_uv)
        inside = ((r_uv[..., 0] >= 0.0) & (r_uv[..., 0] <= 1.0)
                  & (r_uv[..., 1] >= 0.0) & (r_uv[..., 1] <= 1.0))
        reproj = bilinear(acc, r_uv)
        reproj = mix(reproj, luminance(reproj)[..., None], desat[..., None])
        bf = (_smoothstep(0.0, 0.15, c_uv[..., 0]) * _smoothstep(1.0, 0.85, c_uv[..., 0])
              * _smoothstep(0.0, 0.15, c_uv[..., 1]) * _smoothstep(1.0, 0.85, c_uv[..., 1]))
        bf = torch.sqrt(torch.clamp(bf, min=0.0))
        radiance = torch.where(inside[..., None], mix(env_c, reproj, bf[..., None]), env_c)
        val = torch.where(missed[..., None], env_c, radiance) * bsdf[..., None]
        mis = ems_pdf * ems_pdf / (ems_pdf * ems_pdf + pdf * pdf)
        val = val * (torch.where(is_env, mis, 1.0 / pdf) / ems_pdf)[..., None]
        out.append((val, pos))
    (spec, s_pos), (diff, _) = out
    diff = torch.where(is_diffuse[..., None], diff + color, -1.0)
    spec = spec + color
    hit_ws = point(cam.camera_matrix_world, s_pos)
    cam_pos = torch.as_tensor(cam.position, device=dev)
    ray_len = torch.where(s_pos[..., 0] > 1.0e8, 0.0,
                          torch.linalg.vector_norm(hit_ws - cam_pos, dim=-1))
    bg = (depth >= 1.0)[..., None]
    back = torch.cat([color, torch.zeros_like(depth)[..., None]], -1)
    g_diffuse = torch.where(bg, back, torch.cat([diff, rough[..., None]], -1))
    g_specular = torch.where(bg, back, torch.cat([spec, ray_len[..., None]], -1))
    return g_diffuse, {"specular": g_specular}
