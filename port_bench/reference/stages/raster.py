"""Raster and shade, per triangle and per pixel: the G-buffer pass
(`GBufferMaterial.js`), the velocity pass (`VelocityDepthNormalMaterial.js`:
current minus previous screen position under the unjittered camera
and the previous model matrices) and the direct light, as the JAX
package defines them (``scene/rasterizer.py``, ``scene/shading.py``): a
clipless rasterizer on homogeneous edge functions at pixel centres
(each triangle scaled by 1 / sum|w|, a pixel covered where all three
edges agree with the triangle's sign, inside its screen box grown by a
pixel when it lies wholly in front, in front of the eye and within
NDC depth), the nearest NDC depth winning and the lower triangle on a
tie, attributes weighted by e_i / sum e; the sun's Lambert term and the
hemispheric ambient on the albedo (none on metal), the emissive, and
the environment at mip 0 behind the geometry, fetched on a half-
resolution grid and upsampled (per pixel on a frame under 64 pixels
high or wide). Written here as a loop over the
triangles, each over its own screen box.

Compared by :func:`numbers`, over the pixels both give the same
surface. The scene's meshes (their vertices, faces, materials and lights, the
benchmark's inputs), the frame's model matrices and cameras and the
environment's mip 0 are taken as given inputs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .common import bilinear, equirect_uv, normalize, proj_view, screen_to_world, uv_grid

BIG = math.inf


def _geometry(meshes, mats, dev):
    """World positions, normals, faces (global indices), per-face
    material rows and per-face mesh index of the scene under model
    matrices ``mats``."""
    pos, nrm, faces, rows, mesh_of = [], [], [], [], []
    base = 0
    for mesh, m in zip(meshes, mats):
        m = torch.as_tensor(np.asarray(m, np.float32), device=dev)
        p = torch.as_tensor(np.asarray(mesh.positions, np.float32), device=dev)
        n = torch.as_tensor(np.asarray(mesh.normals, np.float32), device=dev)
        rot = m[:3, :3]
        pos.append((rot[None] * p[:, None, :]).sum(-1) + m[:3, 3])
        n = (rot[None] * n[:, None, :]).sum(-1)
        nrm.append(n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-20))
        f = torch.as_tensor(np.asarray(mesh.faces, np.int64), device=dev)
        faces.append(f + base)
        mat = mesh.material
        row = torch.tensor([*mat.diffuse, mat.roughness, mat.metalness, *mat.emissive],
                           dtype=torch.float32, device=dev)
        rows.append(row.expand(len(f), 9))
        mesh_of.append(torch.full((len(f),), float(len(mesh_of)), device=dev))
        base += len(p)
    return (torch.cat(pos), torch.cat(nrm), torch.cat(faces), torch.cat(rows),
            torch.cat(mesh_of))


def _clip(pos, vp):
    vp = torch.as_tensor(np.asarray(vp, np.float32), device=pos.device)
    homo = torch.cat([pos, torch.ones_like(pos[:, :1])], -1)
    return homo @ vp.T


def _scaled(clip, faces, h, w):
    """Per face: homogeneous screen vertices (F, 3, 3) scaled by
    1 / (sum|w| + 1e-6), and the scale."""
    cw = clip[:, 3]
    hv = torch.stack([(0.5 * clip[:, 0] + 0.5 * cw) * w, (0.5 * clip[:, 1] + 0.5 * cw) * h, cw], -1)
    tri = hv[faces]
    scale = 1.0 / (tri[..., 2].abs().sum(-1) + 1e-6)
    return tri * scale[:, None, None], scale


def _edges(tri):
    """(F, 3 edges, 3 coefficients) and the determinant."""
    h0, h1, h2 = tri[:, 0], tri[:, 1], tri[:, 2]
    c = torch.stack([torch.linalg.cross(h1, h2), torch.linalg.cross(h2, h0),
                     torch.linalg.cross(h0, h1)], 1)
    return c, (h0 * c[:, 0]).sum(-1)


def visibility(clip, faces, h, w):
    """(winning face (H, W) or -1, NDC z (H, W))."""
    dev = clip.device
    tri, scale = _scaled(clip, faces, h, w)
    tri_z = clip[faces][..., 2] * scale[:, None]
    coef, det = _edges(tri)
    tw = tri[..., 2]
    valid = (det.abs() > 1e-14) & (det.abs() > 2e-6 * (tw[:, 0] * tw[:, 1] * tw[:, 2]).abs())
    front = (tw > 1e-12).all(1)
    ws = torch.where(tw.abs() > 1e-20, tw, 1e-20)
    px, py = tri[..., 0] / ws, tri[..., 1] / ws
    zbuf = torch.full((h, w), BIG, device=dev)
    ids = torch.full((h, w), -1, dtype=torch.int64, device=dev)
    coef_h, tri_z_h, tw_h = coef.cpu(), tri_z.cpu(), tw.cpu()
    box = torch.stack([px.min(1).values - 1, px.max(1).values + 1,
                       py.min(1).values - 1, py.max(1).values + 1], -1).cpu()
    valid_h, front_h, det_h = valid.cpu(), front.cpu(), det.cpu()
    for f in range(len(faces)):
        if not bool(valid_h[f]):
            continue
        if bool(front_h[f]):
            x0, x1, y0, y1 = (float(v) for v in box[f])
            # pixel centres c + 0.5 inside [lo, hi]
            c0 = max(0, math.ceil(x0 - 0.5))
            c1 = min(w - 1, math.floor(x1 - 0.5))
            r0 = max(0, math.ceil(y0 - 0.5))
            r1 = min(h - 1, math.floor(y1 - 0.5))
            if c0 > c1 or r0 > r1:
                continue
        else:
            c0, c1, r0, r1 = 0, w - 1, 0, h - 1
        xs = torch.arange(c0, c1 + 1, device=dev, dtype=torch.float32)[None, :] + 0.5
        ys = torch.arange(r0, r1 + 1, device=dev, dtype=torch.float32)[:, None] + 0.5
        cf = coef_h[f]
        e = [float(cf[i, 0]) * xs + float(cf[i, 1]) * ys + float(cf[i, 2]) for i in range(3)]
        s = 1.0 if float(det_h[f]) >= 0.0 else -1.0
        cov = (e[0] * s >= 0) & (e[1] * s >= 0) & (e[2] * s >= 0)
        tw_f, tz_f = tw_h[f], tri_z_h[f]
        zw = e[0] * float(tw_f[0]) + e[1] * float(tw_f[1]) + e[2] * float(tw_f[2])
        zc = e[0] * float(tz_f[0]) + e[1] * float(tz_f[1]) + e[2] * float(tz_f[2])
        se = e[0] + e[1] + e[2]
        cov &= zw / torch.where(se.abs() > 1e-20, se, 1e-20) > 1e-6
        z = zc / torch.where(zw.abs() > 1e-20, zw, 1e-20)
        cov &= (z >= -1.0) & (z <= 1.0)
        sub = zbuf[r0:r1 + 1, c0:c1 + 1]
        win = cov & (z < sub)
        zbuf[r0:r1 + 1, c0:c1 + 1] = torch.where(win, z, sub)
        ids[r0:r1 + 1, c0:c1 + 1] = torch.where(win, f, ids[r0:r1 + 1, c0:c1 + 1])
    return ids, zbuf


def _weights(clip, faces, ids, h, w):
    """Per pixel the winner's edge values e_i (H, W, 3) (perspective-
    correct weights are e_i / sum e)."""
    tri, _ = _scaled(clip, faces, h, w)
    coef, _ = _edges(tri)
    c = coef[ids.clamp(min=0)]                     # (H, W, 3, 3)
    dev = clip.device
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :] + 0.5
    ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None] + 0.5
    return c[..., 0] * xs[..., None] + c[..., 1] * ys[..., None] + c[..., 2]


def _interp(attr, faces, ids, e):
    a = attr[faces[ids.clamp(min=0)]]              # (H, W, 3, C)
    return (a * e[..., None]).sum(-2)


def _upsample2(c, n: int, dim: int):
    c = c.movedim(dim, 0)
    a = c[:-1]
    mid = 0.5 * (a + c[1:])
    out = torch.stack([a, mid], 1).reshape((-1,) + tuple(c.shape[1:]))
    return out[:n].movedim(0, dim)


def step(rec):
    scene, cam, unjit, prev = rec["scene"], rec["cam"], rec["unjit"], rec["prev"]
    h, w = rec["height"], rec["width"]
    dev = rec["device"]
    meshes = list(scene.meshes)
    pos, nrm, faces, rows, mesh_of = _geometry(meshes, rec["model"], dev)
    # the G-buffer, on the jittered camera
    clip = _clip(pos, proj_view(cam))
    ids, z = visibility(clip, faces, h, w)
    ok = ids >= 0
    e = _weights(clip, faces, ids, h, w)
    se = e.sum(-1)
    n = _interp(nrm, faces, ids, e) / torch.where(se.abs() > 1e-20, se, 1e-20)[..., None]
    n = torch.where(ok[..., None], normalize(n), 0.0)
    row = rows[ids.clamp(min=0)]
    ok1 = ok[..., None]
    gb = {"diffuse": torch.where(ok1, row[..., 0:4], 0.0), "normal": n,
          "roughness": torch.where(ok, row[..., 4], 1.0),
          "metalness": torch.where(ok, row[..., 5], 0.0),
          "emissive": torch.where(ok1, row[..., 6:9], 0.0),
          "depth": torch.where(ok, z * 0.5 + 0.5, 1.0),
          "mesh": torch.where(ok, mesh_of[ids.clamp(min=0)], -1.0)}
    # the velocity pass: its own scan on the unjittered camera
    clip_u = _clip(pos, proj_view(unjit))
    prev_pos = _geometry(meshes, rec["prev_model"], dev)[0]
    clip_p = _clip(prev_pos, proj_view(prev))
    ids_u, z_u = visibility(clip_u, faces, h, w)
    ok_u = ids_u >= 0
    e_u = _weights(clip_u, faces, ids_u, h, w)
    safe = lambda v: torch.where(v.abs() > 1e-6, v, 1e-6)
    cur = _interp(clip_u[:, [0, 1, 3]], faces, ids_u, e_u)
    old = _interp(clip_p[:, [0, 1, 3]], faces, ids_u, e_u)
    vel = (cur[..., :2] / safe(cur[..., 2:3]) - old[..., :2] / safe(old[..., 2:3])) * 0.5
    se_u = e_u.sum(-1)
    nv = _interp(nrm, faces, ids_u, e_u) / torch.where(se_u.abs() > 1e-20, se_u, 1e-20)[..., None]
    velocity = {"velocity": torch.where(ok_u[..., None], vel, 0.0),
                "normal": torch.where(ok_u[..., None], normalize(nv), 0.0),
                "depth": torch.where(ok_u, z_u * 0.5 + 0.5, 1.0)}
    # the direct light
    if getattr(scene, "sun_specular", 0.0) > 0.0 or getattr(scene, "point_lights", []):
        raise NotImplementedError("specular sun or point lights")
    sun = np.asarray(scene.sun_direction, np.float64)
    sun = torch.tensor(sun / np.linalg.norm(sun), dtype=torch.float32, device=dev)
    sun_c = torch.tensor(np.asarray(scene.sun_color, np.float32) * np.float32(scene.sun_intensity),
                         dtype=torch.float32, device=dev)
    amb = torch.tensor(np.asarray(scene.ambient, np.float32), device=dev)
    albedo = gb["diffuse"][..., :3]
    ndl = torch.clamp((n * sun).sum(-1), min=0.0)
    up = torch.clamp(n[..., 1] * 0.5 + 0.5, 0.0, 1.0)[..., None]
    color = albedo * (1.0 - gb["metalness"])[..., None] * (
        ndl[..., None] * sun_c + amb * (0.5 + 0.5 * up)) + gb["emissive"]
    env0 = rec["env"].mips[0].float()
    cam_pos = torch.as_tensor(cam.position, device=dev)
    if min(h, w) >= 64:
        hc, wc = -(-h // 2) + 1, -(-w // 2) + 1
        uc = (torch.arange(wc, device=dev, dtype=torch.float32) * 2.0 + 0.5) / w
        vc = (torch.arange(hc, device=dev, dtype=torch.float32) * 2.0 + 0.5) / h
        uv_c = torch.stack([uc[None, :].expand(hc, wc), vc[:, None].expand(hc, wc)], -1)
        far = screen_to_world(uv_c, torch.ones((hc, wc), device=dev), cam)
        bg = bilinear(env0, equirect_uv(normalize(far - cam_pos)))
        bg = _upsample2(_upsample2(bg, h, 0), w, 1)
    else:
        far = screen_to_world(uv_grid(h, w, dev), torch.ones((h, w), device=dev), cam)
        bg = bilinear(env0, equirect_uv(normalize(far - cam_pos)))
    color = torch.where((gb["depth"] >= 1.0)[..., None], bg, color)
    return color, {"gbuffer": gb, "velocity": velocity}


#: a pixel of the copy and of this reference shows the same surface where
#: their depth-buffer values agree within this
SAME_SURFACE = 1e-4


def numbers(prog: dict, ref: dict) -> tuple:
    """The raster's numbers, for :func:`check.stage_numbers`, from the
    copy's outputs ``prog`` and this reference's ``ref`` (by leaf): where
    a triangle's edge crosses a pixel centre, or two meshes cut through
    each other (the moving box through the sphere), the two may give the
    pixel to different surfaces (float orderings differ), which moves a
    scalar such as metalness, non-zero on one mesh alone, by a large
    share of its mean. So ``raster_mean`` takes each leaf's mean gap over
    the pixels where both show the same surface (the same mesh and depth
    within :data:`SAME_SURFACE`; for the velocity pass's leaves, its own
    depth), over the mean magnitude there; and ``raster_unmatched`` the
    share of pixels where they do not, in either pass. The mesh index
    (``state.gbuffer.mesh``) serves the match alone."""
    mesh = "state.gbuffer.mesh"
    same = {}
    for pass_ in ("gbuffer", "velocity"):
        k = f"state.{pass_}.depth"
        same[pass_] = (prog[k] - ref[k].to(prog[k].device)).abs() <= SAME_SURFACE
    same["gbuffer"] &= prog[mesh] == ref[mesh].to(prog[mesh].device)
    per = {}
    for k, p in prog.items():
        if k == mesh:
            continue
        m = same["velocity" if ".velocity." in k else "gbuffer"]
        r = ref[k].to(p.device)
        d = (p - r).abs()[m]
        d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
        mag = r.abs()[m]
        per[k] = (float(d.max()) / max(float(r.abs().max()), 1.0),
                  float(d.mean()) / max(float(mag.mean()), 1e-12))
    unmatched = max(1.0 - float(v.float().mean()) for v in same.values())
    return {"raster_mean": max(v[1] for v in per.values()),
            "raster_unmatched": unmatched}, per
