"""Temporal reprojection and accumulation, per pixel: upstream's
`temporal_reproject.frag` with `reproject.frag` (screen to world, log
colour, AABB clamp, the three disocclusion distances, the specular hit
point, the 5-tap Catmull-Rom history), as the JAX package's
``ops/temporal_reproject.py`` states them, with its window: a history
fetch displaced more than +-8 rows or +-30 columns is a disocclusion.
Shared by TRAA, SSGI and SSR."""

from __future__ import annotations

import torch

from .common import (catmull_rom5_window, dot, fwidth, mix, nearest_window, normalize,
                     point, project, screen_to_world, uv_grid, view_z)

KY, KX = 8, 30
MAX_ALPHA = 65536.0


def _confidence(uv_r, depth, world_pos, normal, last_nd, cam, prev_cam, power):
    """`reproject.frag:130-167`."""
    inside = (uv_r[..., 0] >= 0) & (uv_r[..., 0] <= 1) & (uv_r[..., 1] >= 0) & (uv_r[..., 1] <= 1)
    nd, ok = nearest_window(last_nd, uv_r, KY, KX)
    last_pos = screen_to_world(uv_r, nd[..., 3], prev_cam)
    factor = 1.0 + 1.0 / (view_z(depth, cam).abs() + 1.0)
    d = world_pos - last_pos
    dis = (torch.linalg.vector_norm(d, dim=-1) / 10.0 * factor
           + dot(d, normal).abs() / 20.0 * factor
           + torch.clamp(1.0 - dot(normal, nd[..., :3]), max=1.0) / 1.0 * factor)
    conf = torch.clamp(1.0 - torch.clamp(dis, max=1.0), min=0.0) ** power
    return torch.where(inside & ok, conf, 0.0)


def _minmax(tex, center, radius: int):
    """`reproject.frag:53-81`: the AABB of the (2r+1)^2 neighbourhood of
    the input (edges repeated; texels with r < 0 skipped), seeded with
    the centre."""
    h, w = tex.shape[:2]
    valid = (tex[..., 0] >= 0.0)[..., None]
    lo = torch.where(valid, tex[..., :3], 1e30)
    hi = torch.where(valid, tex[..., :3], -1e30)
    ys = torch.arange(h, device=tex.device)
    xs = torch.arange(w, device=tex.device)
    mn, mx = center, center
    for dy in range(-radius, radius + 1):
        r = (ys + dy).clamp(0, h - 1)[:, None]
        for dx in range(-radius, radius + 1):
            c = (xs + dx).clamp(0, w - 1)[None, :]
            mn = torch.minimum(mn, lo[r, c])
            mx = torch.maximum(mx, hi[r, c])
    return mn, mx


def reproject(inputs, history, vel, last_vel, cam, prev_cam, *, log, specular,
              power, input_type, max_blend, clamp_intensity, full_accumulate,
              keep_data, roughness=None):
    """One step over the texture slots ``inputs`` (each (H, W, 4)) with
    their ``history``; ``specular[i]`` reprojects slot i by its hit point.
    ``input_type`` (`temporal_reproject.frag:167-176`): "diffuse_specular"
    (SSGI: the ray length in the second slot's alpha, the roughness in
    the first's), "specular" (SSR: the ray length in the one slot's
    alpha, the G-buffer's ``roughness``) or "diffuse" (TRAA). Returns the
    new (H, W, 4) textures (alpha: the sample count)."""
    fwd = (lambda c: torch.log(c + 1.0)) if log else (lambda c: c)
    inv = (lambda c: torch.exp(c) - 1.0) if log else (lambda c: c)
    depth, normal, v = vel.depth, vel.normal, vel.velocity
    h, w = depth.shape
    uv = uv_grid(h, w, depth.device)
    world_pos = screen_to_world(uv, depth, cam)
    curvature = torch.linalg.vector_norm(fwidth(normal), dim=-1)
    if input_type == "diffuse_specular":
        ray_len = inputs[1][..., 3]
        rough = torch.clamp(inputs[0][..., 3], 0.0, 1.0)
    elif input_type == "specular":
        ray_len = inputs[0][..., 3]
        rough = torch.clamp(roughness, 0.0, 1.0)
    elif input_type == "diffuse":
        ray_len = torch.zeros_like(depth)
        rough = torch.ones_like(depth)
    else:
        raise NotImplementedError(input_type)
    move = torch.clamp((v * v).sum(-1) * 10000.0, max=1.0)
    last_nd = torch.cat([last_vel.normal, last_vel.depth[..., None]], -1)
    d_uv = uv - v
    d_conf = _confidence(d_uv, depth, world_pos, normal, last_nd, cam, prev_cam, power)
    s_uv, s_conf = d_uv, d_conf
    if any(specular):
        # `reproject.frag:169-193`: the hit point along the camera ray
        ok = (curvature <= 0.05) & (ray_len >= 0.01)
        cam_pos = torch.as_tensor(cam.position, device=depth.device)
        hit = cam_pos + normalize(world_pos - cam_pos) * ray_len[..., None]
        clip, cw = project(prev_cam.projection_matrix, point(prev_cam.view_matrix, hit))
        cw = torch.where(cw.abs() > 1e-8, cw, 1e-8)
        h_uv = clip[..., :2] / cw[..., None] * 0.5 + 0.5
        h_conf = _confidence(h_uv, depth, world_pos, normal, last_nd, cam, prev_cam, power)
        s_uv = torch.where(ok[..., None], h_uv, d_uv)
        s_conf = torch.where(ok, h_conf, d_conf)
    out = []
    for i, (inp, hist) in enumerate(zip(inputs, history)):
        spec = specular[i]
        uv_r, conf = (s_uv, s_conf) if spec else (d_uv, d_conf)
        sampled = inp[..., 0] >= 0.0
        c_in = fwd(torch.clamp(inp[..., :3], min=0.0))
        acc = catmull_rom5_window(hist, uv_r, KY, KX)
        acc_raw = fwd(acc[..., :3])
        acc_a = acc[..., 3] + 1.0
        center = inv(c_in)
        if spec:
            mn1, mx1 = _minmax(inp, center, 1)
            mn2, mx2 = _minmax(inp, center, 2)
            one = (rough < 0.25)[..., None]
            mn, mx = torch.where(one, mn1, mn2), torch.where(one, mx1, mx2)
        else:
            mn, mx = _minmax(inp, center, 2)
        clamped = torch.minimum(torch.maximum(acc_raw, fwd(mn)), fwd(mx))
        aggr = torch.clamp(conf * (rough if spec else 1.0), max=1.0)
        intensity = torch.clamp(move * 50.0 + clamp_intensity, max=1.0) * aggr
        new = mix(acc_raw, clamped, intensity[..., None])
        acc_a = acc_a * (1.0 - torch.clamp(torch.linalg.vector_norm(new - acc_raw, dim=-1),
                                           max=1.0))
        c_in = torch.where(sampled[..., None], c_in, acc_raw)
        acc_rgb = torch.where(sampled[..., None], new, acc_raw)
        acc_a = torch.where(sampled, acc_a, acc[..., 3])
        blend = (1.0 - 1.0 / (acc_a + 1.0)) * conf ** power
        top = (1.0 if full_accumulate else max_blend) * keep_data
        top = torch.full_like(blend, top)
        if input_type != "diffuse" and spec:
            low = (rough >= 0.0) & (rough < 0.1)
            gated = mix(top, top * (rough / 0.1), torch.clamp(100.0 * move, max=1.0))
            top = torch.where(low, gated, top)
        t = torch.minimum(blend, top)
        a = torch.clamp(1.0 / (1.0 - t) - 1.0, max=MAX_ALPHA)
        out.append(torch.cat([inv(mix(c_in, acc_rgb, t[..., None])), a[..., None]], -1))
    return out
