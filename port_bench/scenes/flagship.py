"""The flagship scene: a 20 x 20 ground plane, a unit box and a metallic
sphere (734 triangles) under the procedural sky.

Copied from the port's ``scene/geometry.py`` (``make_plane``,
``make_box``, ``make_sphere``), ``analytic.py`` (``flagship_meshes``,
``SPHERE``) and ``core/envmap.py`` (``procedural_sky``), which follow the
JAX repository's ``bench.py:188-197``; the lighting is the port's
``Scene`` defaults, stated here so that the scene does not move with them.
"""

from __future__ import annotations

import numpy as np

PLANE = 20.0
#: centre, radius, albedo, roughness, metalness
SPHERE = ((1.5, 0.6, 0.5), 0.6, (0.2, 0.5, 0.9), 0.2, 0.8)
SKY = (64, 128)
LIGHTING = {"sun_direction": (0.5, 0.8, 0.3), "sun_color": (1.0, 0.96, 0.9),
            "sun_intensity": 2.5, "ambient": (0.25, 0.28, 0.33),
            "background_color": (0.0, 0.0, 0.0)}


def _translation(x, y, z) -> np.ndarray:
    m = np.eye(4)
    m[:3, 3] = (x, y, z)
    return m


def _plane(size: float) -> dict:
    s = size * 0.5
    positions = np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]], np.float32)
    normals = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))
    faces = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return dict(positions=positions, normals=normals, faces=faces, uvs=uvs)


def _box(sx: float, sy: float, sz: float) -> dict:
    hx, hy, hz = sx / 2, sy / 2, sz / 2
    face_defs = [
        ((1, 0, 0), [(hx, -hy, -hz), (hx, hy, -hz), (hx, hy, hz), (hx, -hy, hz)]),
        ((-1, 0, 0), [(-hx, -hy, hz), (-hx, hy, hz), (-hx, hy, -hz), (-hx, -hy, -hz)]),
        ((0, 1, 0), [(-hx, hy, -hz), (-hx, hy, hz), (hx, hy, hz), (hx, hy, -hz)]),
        ((0, -1, 0), [(-hx, -hy, hz), (-hx, -hy, -hz), (hx, -hy, -hz), (hx, -hy, hz)]),
        ((0, 0, 1), [(-hx, -hy, hz), (hx, -hy, hz), (hx, hy, hz), (-hx, hy, hz)]),
        ((0, 0, -1), [(hx, -hy, -hz), (-hx, -hy, -hz), (-hx, hy, -hz), (hx, hy, -hz)]),
    ]
    positions, normals, faces, uvs = [], [], [], []
    for i, (n, quad) in enumerate(face_defs):
        base = 4 * i
        positions.extend(quad)
        normals.extend([n] * 4)
        uvs.extend([(0, 0), (1, 0), (1, 1), (0, 1)])
        faces.append([base, base + 1, base + 2])
        faces.append([base, base + 2, base + 3])
    return dict(positions=np.asarray(positions, np.float32),
                normals=np.asarray(normals, np.float32),
                faces=np.asarray(faces, np.int32), uvs=np.asarray(uvs, np.float32))


def _sphere(radius: float, width_segments: int = 24, height_segments: int = 16) -> dict:
    positions, normals, uvs = [], [], []
    for iy in range(height_segments + 1):
        v = iy / height_segments
        phi = v * np.pi
        for ix in range(width_segments + 1):
            u = ix / width_segments
            theta = u * 2 * np.pi
            n = np.array([np.sin(phi) * np.cos(theta), np.cos(phi),
                          np.sin(phi) * np.sin(theta)])
            normals.append(n)
            positions.append(n * radius)
            uvs.append((u, 1.0 - v))
    faces = []
    stride = width_segments + 1
    for iy in range(height_segments):
        for ix in range(width_segments):
            a = iy * stride + ix
            b, c = a + 1, a + stride
            d = c + 1
            if iy != 0:
                faces.append([a, b, c])
            if iy != height_segments - 1:
                faces.append([b, d, c])
    return dict(positions=np.asarray(positions, np.float32),
                normals=np.asarray(normals, np.float32),
                faces=np.asarray(faces, np.int32), uvs=np.asarray(uvs, np.float32))


def procedural_sky(height: int, width: int, sun_dir=(0.5, 0.6, 0.3),
                   sun_intensity: float = 40.0, sky_tint=(0.35, 0.55, 0.95),
                   ground_tint=(0.25, 0.22, 0.2)) -> np.ndarray:
    """Analytic HDR sky, (H, W, 3) float32: gradient + sun disk."""
    v, u = np.meshgrid((np.arange(height) + 0.5) / height,
                       (np.arange(width) + 0.5) / width, indexing="ij")
    theta = (u - 0.5) * 2.0 * np.pi
    phi = (1.0 - v) * np.pi
    d = np.stack([np.sin(phi) * np.cos(theta), np.cos(phi),
                  np.sin(phi) * np.sin(theta)], axis=-1)
    sun = np.asarray(sun_dir, np.float64)
    sun /= np.linalg.norm(sun)
    cos_sun = (d * sun).sum(-1)
    up = np.clip(d[..., 1], -1.0, 1.0)
    sky = np.asarray(sky_tint)[None, None] * (0.4 + 0.6 * np.clip(up, 0, 1))[..., None]
    ground = np.asarray(ground_tint)[None, None] * (0.3 - 0.2 * np.clip(up, -1, 0))[..., None]
    base = np.where(up[..., None] >= 0.0, sky, ground)
    sun_disk = sun_intensity * np.clip(cos_sun - 0.995, 0.0, 1.0)[..., None] * 200.0
    halo = 0.5 * np.clip(cos_sun, 0.0, 1.0)[..., None] ** 8
    return (base + sun_disk + halo).astype(np.float32)


def generate() -> dict:
    """The meshes (each with its geometry, material and world matrix, by
    name), the sky image and the lighting."""
    (cx, cy, cz), rad, albedo, rough, metal = SPHERE
    meshes = [
        dict(name="plane", **_plane(PLANE),
             material=dict(diffuse=(0.6, 0.6, 0.65, 1.0)), matrix=np.eye(4)),
        dict(name="box", **_box(1.0, 1.0, 1.0),
             material=dict(diffuse=(0.9, 0.3, 0.2, 1.0)),
             matrix=_translation(0, 0.5, 0)),
        dict(name="sphere", **_sphere(rad),
             material=dict(diffuse=tuple(albedo) + (1.0,), roughness=rough,
                           metalness=metal),
             matrix=_translation(cx, cy, cz)),
    ]
    return {"meshes": meshes, "sky": procedural_sky(*SKY), "lighting": dict(LIGHTING)}
