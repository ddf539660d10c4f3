"""Built-in direct-lighting shader producing the "scene color" input.

The reference consumes the user's already-lit three.js render as its
input buffer (`SSGIEffect.js:379-394` renders the scene into
``sceneRenderTarget``). This package is self-contained, so demos and
benches shade the G-buffer here: Lambert sun + optional GGX specular sun
highlight (``scene.sun_specular``) + three.js-style point lights
(``scene.add_point_light``) + hemispheric ambient (with the baked aoMap
term) + emissive, and the environment (or a flat colour) as background.
Pointwise torch ops; the camera's matrices enter as host scalars.
"""

from __future__ import annotations

import torch

from ..core.brdf import calculate_angles, eval_disney_specular, f_schlick
from ..core.envmap import EquirectEnv, sample_equirect_color
from ..core.framebuffers import GBuffer
from ..core.math3d import dot, length, normalize, screen_to_world, uv_grid

#: evaluate the environment background on a half-resolution direction
#: grid at pixel centres and upsample it bilinearly 2x (the view
#: direction field is smooth, so this quarters the background's fetches
#: for at most one env texel of softening). False = an exact per-pixel
#: fetch.
FAST_BACKGROUND = True


def _upsample2(c: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """2x bilinear upsample along ``dim`` aligned to pixel centres:
    out[2i] = c[i], out[2i+1] = (c[i] + c[i+1]) / 2; crops to ``n``."""
    c = c.movedim(dim, 0)
    a = c[:-1]
    mid = 0.5 * (a + c[1:])
    out = torch.stack([a, mid], 1).reshape((-1,) + tuple(c.shape[1:]))
    return out[:n].movedim(0, dim)


def _from(point, pts: torch.Tensor) -> torch.Tensor:
    """``point - pts`` for a host (3,) point and (..., 3) tensors."""
    return torch.stack([float(point[i]) - pts[..., i] for i in range(3)], -1)


def _f0(gbuffer: GBuffer) -> torch.Tensor:
    """Specular reflectance at normal incidence: 0.04 dielectric base
    lerped to albedo by metalness (three.js MeshPhysicalMaterial)."""
    m = gbuffer.metalness[..., None]
    return 0.04 * (1.0 - m) + gbuffer.diffuse[..., :3] * m


def _specular(l, v, n, gbuffer) -> torch.Tensor:
    """Cook-Torrance GGX specular response for light direction ``l``
    (the reference's Disney specular, `ssgi_utils.frag:144-151`, with
    Schlick Fresnel), modulated by NoL. Returns (H, W, 3)."""
    _, nol, noh, _, voh = calculate_angles(l, v, n)
    nov = torch.clamp(dot(n, v), 1e-4, 1.0)
    spec = eval_disney_specular(gbuffer.roughness, noh, nov, nol)
    return f_schlick(_f0(gbuffer), voh) * (spec * nol)[..., None]


def shade_direct(gbuffer: GBuffer, camera, lighting: dict,
                 env: EquirectEnv | None = None, row_offset: int = 0,
                 frame_height: int | None = None) -> torch.Tensor:
    """(H, W, 3) linear HDR scene colour. ``camera``: ``CameraMatrices``;
    ``lighting``: ``Scene.lighting_params`` on the G-buffer's device.

    A row block of a larger frame passes its first row's global index
    ``row_offset`` and the frame's height: each pixel is then shaded at
    its place in the frame, the background grid included."""
    h, w = gbuffer.height, gbuffer.width
    fh = h if frame_height is None else int(frame_height)
    dev = gbuffer.device
    n = gbuffer.normal
    sun_dir = lighting["sun_direction"]
    ndotl = torch.clamp(dot(n, sun_dir), min=0.0)

    albedo = gbuffer.diffuse[..., :3]
    up = torch.clamp(n[..., 1] * 0.5 + 0.5, 0.0, 1.0)[..., None]
    ambient = lighting["ambient"] * (0.5 + 0.5 * up)
    if gbuffer.ao is not None:
        # baked aoMap modulates indirect light only (three.js
        # aomap_fragment applies it to irradiance, not direct)
        ambient = ambient * gbuffer.ao[..., None]

    # metals have no diffuse lobe; their response comes from specular GI
    kd = (1.0 - gbuffer.metalness)[..., None]
    color = albedo * kd * (ndotl[..., None] * lighting["sun_color"] + ambient)

    # world position / view dir: for the specular sun and point lights
    # (key presence is static)
    wants_surface = "sun_specular" in lighting or "point_positions" in lighting
    uv = view_dir = world_pos = None
    if wants_surface or env is not None:
        uv = uv_grid(h, w, dev, row_offset, fh)
    if wants_surface:
        world_pos = screen_to_world(uv, gbuffer.depth, camera.camera_matrix_world,
                                    camera.projection_matrix_inverse)
        view_dir = normalize(_from(camera.position, world_pos))

    if "sun_specular" in lighting:
        color = color + lighting["sun_specular"] * lighting["sun_color"] \
            * _specular(sun_dir, view_dir, n, gbuffer)

    if "point_positions" in lighting:
        # three.js PointLight: inverse-square falloff, windowed cutoff
        # when distance > 0 (lights_fragment getDistanceAttenuation)
        for i in range(lighting["point_positions"].shape[0]):
            to_l = lighting["point_positions"][i] - world_pos
            d = length(to_l)
            l = to_l / torch.clamp(d, min=1e-6)[..., None]
            atten = 1.0 / torch.clamp(d ** lighting["point_decay"][i], min=1e-4)
            cutoff = lighting["point_distance"][i]
            window = torch.where(
                cutoff > 0.0,
                torch.clamp(1.0 - (d / torch.clamp(cutoff, min=1e-6)) ** 4.0,
                            0.0, 1.0) ** 2.0,
                1.0)
            radiance = lighting["point_colors"][i] * (atten * window)[..., None]
            nol = torch.clamp(dot(n, l), min=0.0)
            contrib = albedo * kd * nol[..., None]
            if "sun_specular" in lighting:
                contrib = contrib + lighting["sun_specular"] \
                    * _specular(l, view_dir, n, gbuffer)
            color = color + contrib * radiance

    color = color + gbuffer.emissive

    # background: the environment along the camera ray, else a flat colour
    is_bg = gbuffer.depth >= 1.0
    if env is not None and FAST_BACKGROUND and min(fh, w) >= 64:
        # half-resolution grid at pixel centres (2i + 0.5), bilinear 2x
        # upsample; ceil so odd frame sizes still give >= h / w rows /
        # columns before the crop. A block takes the frame's grid rows
        # from the one at or above its first row to the one below its
        # last, and crops their upsample to its rows.
        hc, wc = -(-fh // 2) + 1, -(-w // 2) + 1
        c0 = min(max(row_offset, 0) // 2, hc - 1)
        c1 = min(max(row_offset + h - 1, 0) // 2 + 1, hc - 1)
        vv, uu = torch.meshgrid(
            (torch.arange(c0, c1 + 1, dtype=torch.float32, device=dev) * 2.0
             + 0.5) / fh,
            (torch.arange(wc, dtype=torch.float32, device=dev) * 2.0 + 0.5) / w,
            indexing="ij")
        far_c = screen_to_world(torch.stack([uu, vv], -1),
                                torch.ones((c1 - c0 + 1, wc), device=dev),
                                camera.camera_matrix_world,
                                camera.projection_matrix_inverse)
        bg_c = sample_equirect_color(env, normalize(-_from(camera.position, far_c)),
                                     0.0)
        bg = _upsample2(_upsample2(bg_c, 2 * (c1 - c0), 0), w, 1)
        # global row g sits at row g - 2 c0 of the upsample; rows of an
        # extended block outside the frame take its nearest row
        rows = (torch.arange(h, device=dev) + row_offset).clamp(0, fh - 1) - 2 * c0
        bg = bg[:h] if (row_offset == 0 and h == fh) else bg[rows]
    elif env is not None:
        far_pos = screen_to_world(uv, torch.ones((h, w), device=dev),
                                  camera.camera_matrix_world,
                                  camera.projection_matrix_inverse)
        bg = sample_equirect_color(env, normalize(-_from(camera.position, far_pos)),
                                   0.0)
    else:
        bg = lighting["background_color"].expand(color.shape)
    return torch.where(is_bg[..., None], bg, color)
