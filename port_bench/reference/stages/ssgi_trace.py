"""The SSGI trace in sweep mode, per pixel: upstream's `ssgi.frag` sample
(a GGX-VNDF specular ray, a cosine diffuse ray, environment importance
samples chosen against roughness, Disney diffuse and specular BRDFs,
MIS, the environment fallback with its luminance clamp, the border
fade, the direct light added) with the JAX package's sweep trace
(``ops/ssgi_sweep.py``): each ray's screen line snapped to one of 16
direction bins (R2-rotated, stochastically rounded by a second noise),
32 geometric radii from 1.5 px to the diagonal read at their rounded
texel offsets, the first step whose view depth lies in [0, thickness)
behind the ray taken as the hit, refined in closed form, and the
radiance of the previous frame's composition, prewarped by the velocity
within +-8 rows and +-30 columns, read at the hit step's texel; the
environment fetched once per 2 x 2 quad at the member the frame picks,
at the nearest mip. Written here as each pixel's own 32 steps.

The environment's prepared tables (its mip levels and the precomposed
inverse-CDF table, ``ctx.env``) are taken as given inputs. The sample
before the trace (:func:`sample`, :func:`choose_rays`) and the shading
after it (:func:`shade`, :func:`pack`) serve SSR's trace
(``ssr_trace.py``) and the march (``ssgi_trace_march.py``) too; options
the references do not follow stop the check (:func:`refuse_options`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .common import (PI, band_row, bilinear, blue_noise, cosine_hemisphere, dot,
                     equirect_uv, ggx_vndf, half, luminance, mix, normalize, onb, point,
                     project, rotate_t, to_index, uv_grid, view_z, window_rows_cols)

EPS = 1e-5
SWEEP_EPS = 1e-6
DIRS, STEPS, MIN_R = 16, 32, 1.5
R2_PHI = 0.6180339887498949


def _clamp_e(x):
    return torch.clamp(x, EPS, 1.0 - EPS)


def _angles(l, v, n):
    hv = normalize(v + l)
    return _clamp_e(dot(n, l)), _clamp_e(dot(n, hv)), _clamp_e(dot(l, hv)), _clamp_e(dot(v, hv))


def _smith_g(ndv, alpha):
    a, b = alpha * alpha, ndv * ndv
    return (2.0 * ndv) / (ndv + torch.sqrt(a + b - a * b))


def _d_gtr(r, noh):
    a2 = r ** 2.0
    return a2 / (PI * ((noh * noh) * (a2 * a2 - 1.0) + 1.0) ** 2.0)


def _equirect_dir(uv):
    theta = (uv[..., 0] - 0.5) * 2.0 * PI
    phi = (1.0 - uv[..., 1]) * PI
    return torch.stack([torch.sin(phi) * torch.cos(theta), torch.cos(phi),
                        torch.sin(phi) * torch.sin(theta)], -1)


def _env_color(env, l, cam, rough, is_diffuse, is_env, env_blur, frame):
    """`ssgi.frag:311-346` with the quad-shared fetch at the nearest mip."""
    mips = [m.float() for m in env.mips]
    d = normalize(rotate_t(cam.view_matrix, l))
    top = len(mips) - 1
    lod = env_blur * top * torch.where((~is_diffuse) & (rough < 0.15), rough / 0.15, 1.0)
    h, w = d.shape[:2]
    fy, fx = frame % 2, (frame // 2) % 2
    ys = (torch.arange(h, device=d.device) // 2 * 2 + fy).clamp(max=h - 1)
    xs = (torch.arange(w, device=d.device) // 2 * 2 + fx).clamp(max=w - 1)
    d, lod = d[ys[:, None], xs[None, :]], lod[ys[:, None], xs[None, :]]
    level = torch.round(torch.clamp(lod, 0.0, float(top)))
    uv = equirect_uv(d)
    out = torch.zeros(d.shape, device=d.device)
    for k, m in enumerate(mips):
        out = torch.where((level == k)[..., None], bilinear(m, uv), out)
    cap = torch.where(is_env, 100.0, 25.0)
    lum = luminance(out)
    return out * torch.where(lum > cap, cap / torch.clamp(lum, min=EPS), 1.0)[..., None]


def _prewarp(acc, vel, uv):
    """acc(q - vel(q)) bilinear within +-8 rows and +-30 columns, with
    its validity as a fourth channel, in float16."""
    tex = half(acc[..., :3])
    h, w = tex.shape[:2]
    p = uv - vel
    x, y = p[..., 0] * w - 0.5, p[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx = torch.where(x0 < 0.0, 0.0, x - x0)
    fy = torch.where(y0 < 0.0, 0.0, y - y0)
    ys, dyc, ok, col = window_rows_cols(to_index(y0), to_index(x0), h, w, 8, 30, reach=1)
    out = 0.0
    for b, wy in ((0, 1.0 - fy), (1, fy)):
        rows = band_row(ys, dyc, b, h, 8, 0, 1)
        row = tex[rows, col(0)] * (1.0 - fx)[..., None] + tex[rows, col(1)] * fx[..., None]
        out = out + row * wy[..., None]
    inside = (p[..., 0] >= 0) & (p[..., 0] <= 1) & (p[..., 1] >= 0) & (p[..., 1] <= 1) & ok
    return half(torch.cat([out, inside.float()[..., None]], -1))


def _table(h: int, w: int, frame: int):
    f32 = np.float32
    xi = f32(np.mod(f32(frame) * f32(R2_PHI), f32(1.0)))
    bw = f32(2.0 * math.pi / DIRS)
    diag = (h * h + w * w) ** 0.5
    ks = np.arange(STEPS, dtype=f32)
    radii = (f32(MIN_R) * (f32(diag) / f32(MIN_R)) ** (ks / f32(STEPS - 1))).astype(f32)
    prev = np.concatenate([[f32(0)], radii[:-1]]).astype(f32)
    ang = ((np.arange(DIRS, dtype=f32) + xi) * bw).astype(f32)
    cos, sin = np.cos(ang).astype(f32), np.sin(ang).astype(f32)
    dx = np.round(radii[None, :] * cos[:, None]).astype(f32)
    dy = np.round(radii[None, :] * sin[:, None]).astype(f32)
    s = (dx * cos[:, None] + dy * sin[:, None]).astype(f32)
    return float(xi), float(bw), diag, dy, dx, s, prev


def _sweep(view_pos, l, z_full, rad, cam, frame, thickness, ray_distance, bin_noise, tab):
    xi, bw, diag, dy_t, dx_t, s_t, prev = tab
    h, w = z_full.shape
    dev = z_full.device
    p = np.asarray(cam.projection_matrix, np.float32)
    sc = (w * 0.5, h * 0.5)
    xyz0, w0 = project(p, view_pos)
    xy0 = xyz0[..., :2] * torch.tensor(sc, device=dev)
    lx, ly, lz = l.unbind(-1)
    xyd = torch.stack([(float(p[0, 0]) * lx + float(p[0, 1]) * ly + float(p[0, 2]) * lz) * sc[0],
                       (float(p[1, 0]) * lx + float(p[1, 1]) * ly + float(p[1, 2]) * lz) * sc[1]], -1)
    wd = float(p[3, 0]) * lx + float(p[3, 1]) * ly + float(p[3, 2]) * lz
    q0 = xy0 / torch.clamp(w0, min=SWEEP_EPS)[..., None] + torch.tensor(sc, device=dev)
    k = xyd * w0[..., None] - xy0 * wd[..., None]
    k_len = torch.linalg.vector_norm(k, dim=-1)
    e = k / torch.clamp(k_len, min=SWEEP_EPS)[..., None]
    ww, w0d = w0 * w0, w0 * wd

    def t_of_s(s):
        den = k_len - s * w0d
        return s * ww / torch.where(den.abs() > SWEEP_EPS, den, SWEEP_EPS), den

    def s_of_t(t):
        return k_len * t / torch.clamp(w0 * (w0 + t * wd), min=SWEEP_EPS)

    phi = torch.atan2(e[..., 1], e[..., 0])
    b = torch.remainder(torch.floor(phi / bw - xi + bin_noise), float(DIRS)).long()
    s_end = torch.where(w0 + ray_distance * wd > SWEEP_EPS,
                        s_of_t(torch.full_like(k_len, ray_distance)), math.inf)
    z0 = view_pos[..., 2]
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    dy_t, dx_t, s_t = (torch.as_tensor(a, device=dev) for a in (dy_t, dx_t, s_t))
    hit = torch.zeros((h, w), dtype=torch.bool, device=dev)
    s_hit, s_lo, z_hit = (torch.zeros((h, w), device=dev) for _ in range(3))
    gi = torch.zeros((h, w, 4), device=dev)
    for j in range(STEPS):
        oy, ox, s = dy_t[b, j].long(), dx_t[b, j].long(), s_t[b, j]
        ty, tx = ys + oy, xs + ox
        inside = (ty >= 0) & (ty < h) & (tx >= 0) & (tx < w)
        ty, tx = ty.clamp(0, h - 1), tx.clamp(0, w - 1)
        t_s, den = t_of_s(s)
        valid = (den > SWEEP_EPS) & (t_s >= 0.0) & (t_s <= ray_distance) & (s <= s_end)
        z_d = z_full[ty, tx]
        diff = z_d - (z0 + t_s * lz)
        new = (~hit) & inside & valid & (diff >= 0.0) & (diff < thickness)
        s_hit = torch.where(new, s, s_hit)
        s_lo = torch.where(new, float(prev[j]), s_lo)
        z_hit = torch.where(new, z_d, z_hit)
        gi = torch.where(new[..., None], rad[ty, tx], gi)
        hit = hit | new
    lz_safe = torch.where(lz.abs() > SWEEP_EPS, lz, SWEEP_EPS)
    t_star = (z_hit - z0) / lz_safe
    s_ref = torch.minimum(torch.maximum(s_of_t(t_star), s_lo), s_hit)
    s_ref = torch.where((t_star >= 0.0) & (t_star <= ray_distance), s_ref, s_hit)
    s_hit = torch.where(hit, s_ref, s_hit)
    inf = torch.full_like(k_len, math.inf)
    sx = torch.where(e[..., 0] > SWEEP_EPS, (w - q0[..., 0]) / e[..., 0],
                     torch.where(e[..., 0] < -SWEEP_EPS, -q0[..., 0] / e[..., 0], inf))
    sy = torch.where(e[..., 1] > SWEEP_EPS, (h - q0[..., 1]) / e[..., 1],
                     torch.where(e[..., 1] < -SWEEP_EPS, -q0[..., 1] / e[..., 1], inf))
    s_exit = torch.minimum(torch.minimum(sx, sy), torch.clamp(s_end, max=diag))
    s_out = torch.where(hit, s_hit, torch.clamp(s_exit, min=0.0))
    uv = (q0 + s_out[..., None] * e) / torch.tensor([float(w), float(h)], device=dev)
    t_hit, _ = t_of_s(s_out)
    pos = torch.where(hit[..., None], view_pos + t_hit[..., None] * l, 1.0e9)
    return uv, pos, ~hit, gi


def _smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def refuse_options(effect, **followed):
    """Stop on an option of ``effect`` that the trace references do not
    follow: they follow the defaults below, and ``followed`` as given."""
    cfg = effect.cfg
    given = dict(mode=cfg.mode, trace=cfg.trace, missed_rays=cfg.missed_rays,
                 importance_sampling=cfg.importance_sampling,
                 env_lum_clamp=cfg.env_lum_clamp, use_direct_light=cfg.use_direct_light,
                 env_box=cfg.env_box, resolution_scale=effect.resolution_scale,
                 sweep_dirs=cfg.sweep_dirs, sweep_steps=cfg.sweep_steps,
                 env_fetch_stride=cfg.env_fetch_stride)
    want = dict(missed_rays=False, importance_sampling=True, env_lum_clamp=True,
                use_direct_light=True, env_box=None, resolution_scale=1.0, **followed)
    other = {k: given[k] for k, v in want.items() if given[k] != v}
    if other:
        raise NotImplementedError(f"the trace reference follows no {other}")


def sample(ctx, ssr: bool) -> dict:
    """`ssgi.frag:120-190`, per pixel: the view and world frame, the
    frame's blue noise (r1-r4), the GGX-VNDF reflection ``l_view`` and the
    choice of a diffuse sample. SSR (``ssr``; `SSREffect.js:3-9`) draws
    none: every pixel takes the specular branch."""
    gb, cam, frame = ctx.gbuffer, ctx.cam, ctx.frame_index
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
    r1, r2, r3, r4 = blue_noise(h, w, frame, dev).unbind(-1)
    hl = ggx_vndf(v_loc, r_sq, r1, r2)
    hl = torch.where(hl[..., 2:3] < 0.0, -hl, hl)
    i = -v_loc
    l_loc = normalize(i - 2.0 * dot(hl, i)[..., None] * hl)
    l_world = l_loc[..., 0:1] * t_w + l_loc[..., 1:2] * b_w + l_loc[..., 2:3] * n_world
    l_view = normalize(rotate_t(cam.camera_matrix_world, l_world))
    if ssr:
        is_diffuse = torch.zeros_like(depth, dtype=torch.bool)
    else:
        f0 = mix(torch.full_like(albedo, 0.04), albedo, metal[..., None])
        voh = _angles(l_view, v, n)[3]
        fres = f0 + (1.0 - f0) * ((1.0 - voh) ** 5.0)[..., None]
        diff_w = torch.clamp((1.0 - metal) * luminance(albedo), min=EPS)
        spec_w = torch.clamp(luminance(fres), min=EPS)
        is_diffuse = r3 < diff_w * (1.0 / (diff_w + spec_w))
    sat_mx, sat_mn = albedo.max(-1).values, albedo.min(-1).values
    sat = torch.where(sat_mx == sat_mn, 0.0, (sat_mx - sat_mn) / torch.clamp(sat_mx, min=EPS))
    return dict(ssr=ssr, depth=depth, rough=rough, metal=metal, uv=uv, r_sq=r_sq, vz=vz,
                view_pos=view_pos, n=n, v=v, nov=nov, r1=r1, r2=r2, r3=r3, r4=r4,
                l_view=l_view, is_diffuse=is_diffuse, desat=(1.0 - rough) * sat * 0.4)


def choose_rays(s: dict, env_pdf, env_dir) -> list:
    """`ssgi.frag:191-240`: the environment's importance sample (its pdf
    and view direction) taken against roughness, and the MIS pdf, both
    recorded in ``s`` (``is_env``, ``ems_pdf``); returns the rays:
    [specular] in SSR, [specular, diffuse (cosine)] in SSGI."""
    prob = torch.clamp(dot(env_dir, s["n"]) * s["rough"], max=1.0 - EPS)
    is_env = s["r4"] < prob
    s["is_env"] = is_env
    s["ems_pdf"] = torch.clamp(torch.where(is_env, env_pdf / torch.clamp(1.0 - prob, min=EPS),
                                           1.0 - prob), min=EPS)
    rays = [torch.where(is_env[..., None], env_dir, s["l_view"])]
    if not s["ssr"]:
        cos_hemi = cosine_hemisphere(s["n"], torch.stack([s["r1"], s["r2"]], -1))
        rays.append(torch.where(is_env[..., None], env_dir, cos_hemi))
    return rays


def shade(s: dict, l, c_uv, missed, env_c, reproj, inside):
    """`ssgi.frag:362-439` and `:252-259` for one ray: the Disney diffuse
    or specular BRDF and its pdf, the hit's radiance ``reproj`` (where
    ``inside``) desaturated and faded into the environment ``env_c`` at
    the border of ``c_uv``, the environment on a miss, weighted by brdf
    / pdf and MIS."""
    r_sq, nov, is_diffuse = s["r_sq"], s["nov"], s["is_diffuse"]
    nol, noh, loh, _ = _angles(l, s["v"], s["n"])
    cos_t = torch.clamp(dot(s["n"], l), min=0.0)
    fd90 = 0.5 + 2.0 * r_sq * loh ** 2.0
    f_l = 1.0 + (fd90 - 1.0) * (1.0 - nol) ** 5.0
    f_v = 1.0 + (fd90 - 1.0) * (1.0 - nov) ** 5.0
    d_brdf = (f_l * f_v / PI) * (1.0 - s["metal"])
    g = _smith_g(nov, ((0.5 + r_sq * 0.5) ** 2.0) ** 2.0) * \
        _smith_g(nol, ((0.5 + r_sq * 0.5) ** 2.0) ** 2.0)
    s_brdf = _d_gtr(r_sq, noh) * g / (4.0 * nol * nov)
    s_pdf = _d_gtr(r_sq, noh) * _smith_g(nov, r_sq * r_sq) / torch.clamp(4.0 * nov, min=1e-5)
    bsdf = torch.where(is_diffuse, d_brdf, s_brdf) * cos_t
    pdf = torch.clamp(torch.where(is_diffuse, nol / PI, s_pdf), min=EPS)
    reproj = mix(reproj, luminance(reproj)[..., None], s["desat"][..., None])
    bf = (_smoothstep(0.0, 0.15, c_uv[..., 0]) * _smoothstep(1.0, 0.85, c_uv[..., 0])
          * _smoothstep(0.0, 0.15, c_uv[..., 1]) * _smoothstep(1.0, 0.85, c_uv[..., 1]))
    bf = torch.sqrt(torch.clamp(bf, min=0.0))
    radiance = torch.where(inside[..., None], mix(env_c, reproj, bf[..., None]), env_c)
    val = torch.where(missed[..., None], env_c, radiance) * bsdf[..., None]
    ems_pdf = s["ems_pdf"]
    mis = ems_pdf * ems_pdf / (ems_pdf * ems_pdf + pdf * pdf)
    return val * (torch.where(s["is_env"], mis, 1.0 / pdf) / ems_pdf)[..., None]


def pack(s: dict, color, cam, out):
    """`ssgi.frag:267-308`: the direct light ``color`` added, the diffuse
    output -1 where no diffuse sample was drawn, the specular ray's
    world length (0 on a miss), the background the direct light; ``out``
    is [(value, view-space hit)] by ray. Returns (g_diffuse, {"specular":
    g_specular})."""
    (spec, s_pos) = out[0]
    if s["ssr"]:
        diff = torch.full_like(spec, -1.0)
    else:
        diff = torch.where(s["is_diffuse"][..., None], out[1][0] + color, -1.0)
    spec = spec + color
    hit_ws = point(cam.camera_matrix_world, s_pos)
    cam_pos = torch.as_tensor(cam.position, device=spec.device)
    ray_len = torch.where(s_pos[..., 0] > 1.0e8, 0.0,
                          torch.linalg.vector_norm(hit_ws - cam_pos, dim=-1))
    depth, rough = s["depth"], s["rough"]
    bg = (depth >= 1.0)[..., None]
    back = torch.cat([color, torch.zeros_like(depth)[..., None]], -1)
    g_diffuse = torch.where(bg, back, torch.cat([diff, rough[..., None]], -1))
    g_specular = torch.where(bg, back, torch.cat([spec, ray_len[..., None]], -1))
    return g_diffuse, {"specular": g_specular}


def trace(rec, ssr: bool):
    """The sweep trace of SSGI (both rays) or, with ``ssr``, of SSR (the
    specular ray): (g_diffuse, {"specular": g_specular})."""
    ctx, color, state = rec["ctx"], rec["color"], rec["state"]
    effect = rec["effect"]
    refuse_options(effect, mode="ssr" if ssr else "ssgi", trace="sweep", sweep_dirs=DIRS,
                   sweep_steps=STEPS, env_fetch_stride=2)
    u = ctx.params[effect.name]
    cam, env, frame = ctx.cam, ctx.env, ctx.frame_index
    s = sample(ctx, ssr)
    h, w = s["depth"].shape
    dev = s["depth"].device
    # environment importance sample from the precomposed inverse CDF
    eh, ew = env.mips[0].shape[0], env.mips[0].shape[1]
    t = bilinear(env.cdf_packed.float(), torch.stack([s["r2"], s["r1"]], -1))
    env_pdf = (ew * eh) * (t[..., 2] / float(env.total_sum))
    env_dir = normalize(rotate_t(cam.camera_matrix_world, _equirect_dir(t[..., 0:2])))
    rays = choose_rays(s, env_pdf, env_dir)
    rad = _prewarp(state["composed"], ctx.velocity.velocity, s["uv"])
    bin_noise = blue_noise(h, w, frame + 2048, dev)[..., 0]
    tab = _table(h, w, frame)
    out = []
    for l in rays:
        c_uv, pos, missed, gi = _sweep(s["view_pos"], l, s["vz"], rad, cam, frame,
                                       u["thickness"], u["ray_distance"], bin_noise, tab)
        env_c = _env_color(env, l, cam, s["rough"], s["is_diffuse"], s["is_env"],
                           u["env_blur"], frame)
        out.append((shade(s, l, c_uv, missed, env_c, gi[..., :3], gi[..., 3] > 0.5), pos))
    return pack(s, color, cam, out)


def step(rec):
    return trace(rec, ssr=False)
