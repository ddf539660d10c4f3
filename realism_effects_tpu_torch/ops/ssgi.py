"""SSGI: stochastic screen-space GI (`ssgi.frag`, `ssgi_utils.frag`), the
JAX package's ``ops/ssgi.py``.

Per pixel: one GGX-VNDF, cosine-hemisphere or environment-CDF sample,
both rays (specular, diffuse) traced, radiance from last frame's
composed output reprojected by its velocity, environment fallback with
MIS. ``trace="sweep"`` traces with the direction-binned sweep
(``ops/ssgi_sweep.py``) and reads the radiance prewarped; ``"march"`` is
the reference's per-pixel march (:func:`view_space_ray_march`), which
fetches the velocity and the radiance at each hit, the exact
environment CDF chain and the trilinear environment fetch.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import tracing
from ..core import brdf, math3d
from ..core.envmap import (EquirectEnv, sample_equirect_color,
                           sample_equirect_probability)
from ..core.framebuffers import GBuffer, VelocityBuffer
from ..core.math3d import (dot, luminance, mix, normalize, smoothstep,
                           transform_dir_transpose, uv_grid)
from ..core.rng import blue_noise_image, blue_noise_transform
from ..core.sampling import sample_bilinear, sample_nearest
from ..parallel.sharding import replicate_for_rolls
from . import march_kernel, shade_kernel
from .ssgi_sweep import (MIN_RADIUS, march_inputs, step_table, sweep_ray_march,
                         sweep_results)
from .sweep_kernel import sweep_march
from .warp import bilinear_window

EPS = 1e-5

#: the ``pass:<mode>.<pass>`` span names of the chain by mode ("ssgi" |
#: "ssr"), built once: setup (selection, sampling, the sweep's bin
#: noise), prewarp (the sweep's radiance), trace, march (the per-pixel
#: march's launches, inside trace), shade (radiance, brdf / pdf / MIS
#: and the packed outputs), and the effect's reproject, denoise and
#: compose
PASS_SPANS = {mode: {p: f"pass:{mode}.{p}" for p in (
    "setup", "prewarp", "trace", "march", "shade", "reproject", "denoise",
    "compose")} for mode in ("ssgi", "ssr")}


@dataclasses.dataclass(frozen=True)
class SSGIConfig:
    """Static options; the JAX package's fields and defaults
    (``defaultSSGIOptions``, `SSGIOptions.js:26-48`)."""

    mode: str = "ssgi"               # "ssgi" | "ssr"
    steps: int = 20
    refine_steps: int = 5
    #: "sweep" (the direction-binned march) or "march" (the reference's
    #: per-pixel march, `ssgi.frag:441-503`)
    trace: str = "sweep"
    sweep_dirs: int = 16
    sweep_steps: int = 32
    missed_rays: bool = False
    importance_sampling: bool = True
    env_lum_clamp: bool = True
    #: add the direct light to both GI outputs (`ssgi.frag:267-272`)
    use_direct_light: bool = True
    #: box-projected env parallax correction: ((sx, sy, sz), (px, py, pz))
    env_box: tuple | None = None
    #: sweep trace: each stride x stride pixel quad shares one
    #: environment fetch a frame, the fetched member rotating with the
    #: frame (the march fetches per pixel)
    env_fetch_stride: int = 2


def view_space_ray_march(view_pos, l, depth_tex, cam, random_b, thickness,
                         ray_distance, cfg: SSGIConfig):
    """RayMarch + BinarySearch (`ssgi.frag:441-503`), every lane
    ``cfg.steps - 1`` steps of ``l * ray_distance / steps`` eased by
    ``1 - exp(-0.25 (i + random_b - 0.5)^2)``; a hit is the first
    ``0 <= diff < thickness`` against the nearest depth texel, refined by
    ``cfg.refine_steps`` bisections from half a step back. Returns (uv,
    hit_pos (view), missed); missed lanes hold hit_pos = 1e9, the
    reference's sentinel. CUDA tensors launch ``csrc/sweep.cu``'s
    ``ray_march_kernel`` (``ops/march_kernel.py``); CPU tensors take
    :func:`view_space_ray_march_plain`."""
    if view_pos.device.type == "cpu":
        return view_space_ray_march_plain(view_pos, l, depth_tex, cam, random_b,
                                          thickness, ray_distance, cfg)
    return march_kernel.launch(view_pos, l, depth_tex, cam, random_b, thickness,
                               ray_distance, cfg.steps, cfg.refine_steps)


def view_space_ray_march_plain(view_pos, l, depth_tex, cam, random_b, thickness,
                               ray_distance, cfg: SSGIConfig):
    """:func:`view_space_ray_march` as whole-frame torch operations, each
    lane stepped to the end (a lane that has hit holds its position)."""
    p = cam.projection_matrix
    step_dir = l * (ray_distance / float(cfg.steps))
    hit = torch.zeros(view_pos.shape[:-1], dtype=torch.bool, device=view_pos.device)
    hit_pos = view_pos
    uv = math3d.view_to_screen(view_pos, p)
    for i in range(1, cfg.steps):
        x = float(i) + random_b - 0.5
        cs = 1.0 - torch.exp(-0.25 * (x * x))
        advanced = hit_pos + step_dir * cs[..., None]
        cur_pos = torch.where(hit[..., None], hit_pos, advanced)
        cur_uv = math3d.view_to_screen(cur_pos, p)
        z = math3d.depth_to_view_z(sample_nearest(depth_tex, cur_uv), cam)
        diff = z - cur_pos[..., 2]
        newly_hit = (~hit) & (diff >= 0.0) & (diff < thickness)
        uv = torch.where(hit[..., None], uv, cur_uv)
        hit = hit | newly_hit
        hit_pos = cur_pos

    if cfg.refine_steps > 0:
        bdir = (step_dir * 0.5).expand_as(hit_pos)
        bpos = hit_pos - bdir
        for _ in range(cfg.refine_steps):
            b_uv = math3d.view_to_screen(bpos, p)
            z = math3d.depth_to_view_z(sample_nearest(depth_tex, b_uv), cam)
            diff = z - bpos[..., 2]
            bdir = bdir * 0.5
            bpos = bpos + torch.where((diff >= 0.0)[..., None], -bdir, bdir)
        uv = torch.where(hit[..., None], math3d.view_to_screen(bpos, p), uv)
        hit_pos = torch.where(hit[..., None], bpos, hit_pos)

    missed = ~hit
    return uv, torch.where(missed[..., None], 1.0e9, hit_pos), missed


def _parallax_correct(reflected_ws, world_pos, cfg: SSGIConfig):
    """Box-projected env correction (`ssgi_utils.frag:44-56`)."""
    size = tracing.to_device(cfg.env_box[0], world_pos.device, torch.float32,
                             "ssgi.env_box_size")
    pos = tracing.to_device(cfg.env_box[1], world_pos.device, torch.float32,
                            "ssgi.env_box_position")
    safe = torch.where(reflected_ws.abs() > 1e-8, reflected_ws, 1e-8)
    rbmax = (0.5 * size + pos - world_pos) / safe
    rbmin = (-0.5 * size + pos - world_pos) / safe
    rbminmax = torch.where(reflected_ws > 0.0, rbmax, rbmin)
    correction = rbminmax.min(dim=-1, keepdim=True).values
    return normalize(world_pos + reflected_ws * correction - pos)


def _env_fetch_strided(env, dirs_ws, lod, stride: int, frame: int,
                       quantize: bool, row_offset: int = 0,
                       frame_height: int | None = None):
    """One environment fetch per stride x stride quad, at the member
    (frame % stride, frame // stride % stride); quads past the frame
    edge read the edge pixel. A row block of a larger frame (first row
    ``row_offset``) fetches the frame's quads over its rows; a row within
    ``stride - 1`` of the block's edge may read a member past it, which a
    halo of that many rows holds."""
    h, w = dirs_ws.shape[:2]
    fh = h if frame_height is None else int(frame_height)
    fy = frame % stride
    fx = frame // stride % stride
    wq = -(-w // stride)
    dev = dirs_ws.device
    g0, g1 = max(row_offset, 0), min(row_offset + h, fh) - 1
    q0 = g0 // stride
    nq = g1 // stride - q0 + 1
    rows = torch.clamp((torch.arange(nq, device=dev) + q0) * stride + fy,
                       max=fh - 1)
    if row_offset != 0 or h != fh:
        rows = torch.clamp(rows - row_offset, 0, h - 1)
    cols = torch.clamp(torch.arange(wq, device=dev) * stride + fx, max=w - 1)
    s = sample_equirect_color(env, dirs_ws[rows][:, cols], lod[rows][:, cols],
                              quantize=quantize)
    s = s[:, None, :, None, :].expand(nq, stride, wq, stride, 3)
    s = s.reshape(nq * stride, wq * stride, 3)
    if row_offset == 0 and h == fh:
        return s[:h, :w]
    # block row j is frame row row_offset + j, of quad row (row_offset +
    # j) // stride; the halo rows past the frame take its edge row
    idx = torch.arange(h, device=dev).add_(row_offset).clamp_(g0, g1) - q0 * stride
    return s[idx, :w]


def _get_env_color(env: EquirectEnv | None, l_view, view_matrix, roughness,
                   is_diffuse, is_env_sample, env_blur, cfg: SSGIConfig,
                   world_pos=None, frame: int | None = None,
                   rows: tuple = (0, None)):
    """`ssgi.frag:311-346`: equirect fetch at a roughness-scaled mip,
    luminance-clamped; the sweep trace rounds the lod to a level and
    shares the fetch among stride x stride quads, the march fetches
    trilinear per pixel. ``rows``: a row block's (row_offset,
    frame_height)."""
    if env is None:
        return torch.zeros(l_view.shape[:-1] + (3,), device=l_view.device)
    reflected_ws = normalize(transform_dir_transpose(view_matrix, l_view))
    if cfg.env_box is not None and world_pos is not None:
        reflected_ws = _parallax_correct(reflected_ws, world_pos, cfg)
    mip = float(env_blur) * float(env.max_mip_level)
    mip_scale = torch.where((~is_diffuse) & (roughness < 0.15),
                            roughness / 0.15, 1.0)
    lod = (mip * mip_scale).expand(l_view.shape[:-1])
    sweep = cfg.trace == "sweep"
    if sweep and cfg.env_fetch_stride > 1 and frame is not None:
        sample = _env_fetch_strided(env, reflected_ws, lod,
                                    cfg.env_fetch_stride, frame, quantize=True,
                                    row_offset=rows[0], frame_height=rows[1])
    else:
        sample = sample_equirect_color(env, reflected_ws, lod, quantize=sweep)
    if cfg.env_lum_clamp:
        max_env_lum = torch.where(is_env_sample, 100.0, 25.0)
        env_lum = luminance(sample)
        scale = torch.where(env_lum > max_env_lum,
                            max_env_lum / torch.clamp(env_lum, min=EPS), 1.0)
        sample = sample * scale[..., None]
    return sample


def _saturation(c):
    """`ssgi.frag:348-360`."""
    mx = c.max(dim=-1).values
    mn = c.min(dim=-1).values
    return torch.where(mx == mn, 0.0, (mx - mn) / torch.clamp(mx, min=EPS))


#: the vertical reach of the radiance prewarp: its window (8 rows) and
#: the bilinear footprint (1)
PREWARP_HALO = 9


def _setup(gbuffer: GBuffer, env, cam, frame: int, cfg: SSGIConfig,
           row_offset: int = 0, frame_height: int | None = None) -> dict:
    """The per-pixel sampling before the trace (`ssgi.frag:120-240`): the
    view and world geometry, the blue noise, the GGX / cosine /
    environment ray choice and the MIS pdf; ``rays`` is [specular] or
    [specular, diffuse]. Every value is a function of the pixel alone
    (and its global row)."""
    sweep = cfg.trace == "sweep"
    h, w = gbuffer.depth.shape
    fh = h if frame_height is None else int(frame_height)
    dev = gbuffer.depth.device
    uv = uv_grid(h, w, dev, row_offset, fh)
    depth = gbuffer.depth

    roughness = gbuffer.roughness
    metalness = gbuffer.metalness
    diffuse = gbuffer.diffuse[..., :3]
    roughness_sq = torch.clamp(roughness * roughness, 1e-6, 1.0)

    view_z = math3d.depth_to_view_z(depth, cam)
    view_pos = math3d.get_view_position(uv, view_z, cam.projection_matrix,
                                        cam.projection_matrix_inverse)
    view_dir = normalize(view_pos)
    world_normal = gbuffer.normal
    view_normal = normalize(transform_dir_transpose(cam.camera_matrix_world,
                                                    world_normal))
    world_pos = math3d.transform_point(cam.camera_matrix_world, view_pos)

    n = view_normal
    v = -view_dir
    nov = torch.clamp(dot(n, v), min=EPS)

    # view direction in world space (`ssgi.frag:136`)
    v_world = transform_dir_transpose(cam.view_matrix, v)
    t_w, b_w = brdf.onb(world_normal)
    v_local = brdf.to_local(t_w, b_w, world_normal, v_world)

    f0 = mix(torch.full_like(diffuse, 0.04), diffuse, metalness[..., None])

    random = blue_noise_image(h, w, frame, row_offset=row_offset, device=dev)
    r1, r2, r3, r4 = random.unbind(-1)

    # GGX-VNDF reflection direction (`ssgi.frag:156-166`)
    h_local = brdf.sample_ggx_vndf(v_local, roughness_sq, roughness_sq, r1, r2)
    h_local = torch.where(h_local[..., 2:3] < 0.0, -h_local, h_local)
    l_local = normalize(math3d.reflect(-v_local, h_local))
    l_world = brdf.to_world(t_w, b_w, world_normal, l_local)
    l_view = normalize(transform_dir_transpose(cam.camera_matrix_world, l_world))

    if cfg.mode == "ssgi":
        _, _, _, _, voh = brdf.calculate_angles(l_view, v, n)
        fresnel = brdf.f_schlick(f0, voh)
        diff_w = torch.clamp((1.0 - metalness) * luminance(diffuse), min=EPS)
        spec_w = torch.clamp(luminance(fresnel), min=EPS)
        inv_w = 1.0 / (diff_w + spec_w)
        is_diffuse_sample = r3 < diff_w * inv_w
    else:
        is_diffuse_sample = torch.zeros((h, w), dtype=torch.bool, device=dev)

    # environment importance sampling (`ssgi.frag:191-215`), evaluated on
    # the 128^2 noise tile: it depends on the blue noise alone
    ems_pdf = torch.ones((h, w), device=dev)
    is_env_sample = torch.zeros((h, w), dtype=torch.bool, device=dev)
    env_mis_dir = torch.zeros((h, w, 3), device=dev)
    if cfg.importance_sampling and env is not None:
        def cdf_on_tile(t):
            pdf_t, dir_t = sample_equirect_probability(env, t[..., :2],
                                                       fast=sweep)
            return torch.cat([pdf_t[..., None], dir_t], dim=-1)

        packed_env = blue_noise_transform(h, w, frame, cdf_on_tile,
                                          row_offset=row_offset, device=dev)
        env_pdf, env_dir_ws = packed_env[..., 0], packed_env[..., 1:4]
        env_mis_dir = normalize(transform_dir_transpose(
            cam.camera_matrix_world, env_dir_ws))
        prob = torch.clamp(dot(env_mis_dir, view_normal) * roughness,
                           max=1.0 - EPS)
        is_env_sample = r4 < prob
        ems_pdf = torch.where(
            is_env_sample, env_pdf / torch.clamp(1.0 - prob, min=EPS),
            1.0 - prob)
        ems_pdf = torch.clamp(ems_pdf, min=EPS)

    cos_hemi = brdf.cosine_sample_hemisphere(view_normal,
                                             torch.stack([r1, r2], dim=-1))
    diffuse_ray = torch.where(is_env_sample[..., None], env_mis_dir, cos_hemi)
    specular_ray = torch.where(is_env_sample[..., None], env_mis_dir, l_view)
    rays = [specular_ray] + ([diffuse_ray] if cfg.mode == "ssgi" else [])
    return dict(uv=uv, depth=depth, roughness=roughness, metalness=metalness,
                diffuse=diffuse, roughness_sq=roughness_sq, view_pos=view_pos,
                world_pos=world_pos, view_normal=view_normal, n=n, v=v,
                nov=nov, r3=r3, is_diffuse_sample=is_diffuse_sample,
                ems_pdf=ems_pdf, is_env_sample=is_env_sample, rays=rays,
                rows=(row_offset, fh))


def _prewarp(accumulated, velocity, uv, row_offset: int = 0,
             frame_height: int | None = None):
    """Prewarped accumulated radiance A'(q) = acc(q - vel(q)) through the
    bilinear window warp, with a validity channel, float16 (H, W, 4): the
    sweep reads it at each ray's hit texel. Reach: :data:`PREWARP_HALO`."""
    acc16 = accumulated[..., :3].to(torch.float16).to(torch.float32)
    pre_uv = uv - velocity.velocity
    warped_acc, in_win = bilinear_window(acc16.contiguous(), pre_uv,
                                         ky=8, kx=30, row_offset=row_offset,
                                         frame_height=frame_height)
    pre_ok = ((pre_uv[..., 0] >= 0.0) & (pre_uv[..., 0] <= 1.0)
              & (pre_uv[..., 1] >= 0.0) & (pre_uv[..., 1] <= 1.0) & in_win)
    return torch.cat([warped_acc, pre_ok.to(torch.float32)[..., None]],
                     dim=-1).to(torch.float16)


def _bin_noise(p: dict, frame: int):
    """Stochastic bin rounding of the sweep: a second blue-noise image,
    independent of r1-r4."""
    h, w = p["depth"].shape
    return blue_noise_image(h, w, frame + 2048, row_offset=p["rows"][0],
                            device=p["depth"].device)[..., 0]


def _shade(p: dict, traces, velocity_tex, accumulated, direct_light, env, cam,
           frame: int, cfg: SSGIConfig, env_blur):
    """`ssgi.frag:241-308` after the trace: each ray's radiance (the
    march's from ``velocity_tex`` and ``accumulated`` at its hit, read
    anywhere in the frame; the sweep's from its trace), environment
    fallback, brdf / pdf / MIS weighting, and the two packed outputs.
    CUDA tensors launch ``csrc/shade.cu``'s ``shade_kernel``
    (``ops/shade_kernel.py``); CPU tensors take :func:`_shade_plain`."""
    if p["depth"].device.type == "cpu":
        return _shade_plain(p, traces, velocity_tex, accumulated, direct_light,
                            env, cam, frame, cfg, env_blur)
    return shade_kernel.shade(p, traces, velocity_tex, accumulated, direct_light,
                              env, cam, frame, cfg, env_blur)


def _shade_plain(p: dict, traces, velocity_tex, accumulated, direct_light, env,
                 cam, frame: int, cfg: SSGIConfig, env_blur):
    """:func:`_shade` as whole-frame torch operations."""
    sweep = cfg.trace == "sweep"
    depth, roughness = p["depth"], p["roughness"]
    metalness, diffuse = p["metalness"], p["diffuse"]
    roughness_sq, nov = p["roughness_sq"], p["nov"]
    view_normal, n, v = p["view_normal"], p["n"], p["v"]
    is_diffuse_sample, is_env_sample = p["is_diffuse_sample"], p["is_env_sample"]
    ems_pdf = p["ems_pdf"]
    h, w = depth.shape
    dev = depth.device
    is_bg = depth >= 1.0
    sat_desat = (1.0 - roughness) * _saturation(diffuse) * 0.4

    def do_sample(l, trace, is_diffuse_mask):
        """`ssgi.frag:362-439` for one ray."""
        _, s_nol, s_noh, s_loh, _ = brdf.calculate_angles(l, v, n)
        cos_theta = torch.clamp(dot(view_normal, l), min=0.0)
        diffuse_brdf = brdf.eval_disney_diffuse(s_nol, nov, s_loh,
                                                roughness_sq, metalness)
        diffuse_pdf = s_nol / math.pi
        spec_brdf = brdf.eval_disney_specular(roughness_sq, s_noh, nov, s_nol)
        spec_pdf = brdf.ggx_vndf_pdf(s_noh, nov, roughness_sq)
        brdf_val = torch.where(is_diffuse_mask, diffuse_brdf, spec_brdf)
        pdf = torch.clamp(torch.where(is_diffuse_mask, diffuse_pdf, spec_pdf),
                          min=EPS)
        brdf_val = brdf_val * cos_theta

        coords, hit_pos, missed = trace[:3]
        env_color = _get_env_color(
            env, l, cam.view_matrix, roughness, is_diffuse_mask,
            is_env_sample, env_blur, cfg, world_pos=p["world_pos"],
            frame=frame, rows=p["rows"])

        if sweep:
            # the prewarped radiance (+ validity) read at the hit texel
            reproj_gi = trace[3][..., :3]
            in_bounds = trace[3][..., 3] > 0.5
        else:
            # the velocity (NearestFilter) at the hit, then last frame's
            # output there (an rgba16f LinearFilter target)
            reproj_uv = coords - sample_nearest(velocity_tex, coords)
            in_bounds = ((reproj_uv[..., 0] >= 0.0) & (reproj_uv[..., 0] <= 1.0)
                         & (reproj_uv[..., 1] >= 0.0) & (reproj_uv[..., 1] <= 1.0))
            reproj_gi = sample_bilinear(accumulated[..., :3], reproj_uv, half=True)
        reproj_gi = mix(reproj_gi, luminance(reproj_gi)[..., None],
                        sat_desat[..., None])

        border = 0.15
        bf = (smoothstep(0.0, border, coords[..., 0])
              * smoothstep(1.0, 1.0 - border, coords[..., 0])
              * smoothstep(0.0, border, coords[..., 1])
              * smoothstep(1.0, 1.0 - border, coords[..., 1]))
        bf = torch.sqrt(torch.clamp(bf, min=0.0))
        radiance = mix(env_color, reproj_gi, bf[..., None])
        radiance = torch.where(in_bounds[..., None], radiance, env_color)
        if cfg.missed_rays:
            # the brighter of env and ssgi on missed lanes (`:430-436`)
            take_env = luminance(env_color) > luminance(radiance)
            gi = torch.where((missed & take_env)[..., None], env_color, radiance)
        else:
            gi = torch.where(missed[..., None], env_color, radiance)
        return gi, hit_pos, brdf_val, pdf

    def finalize(gi, brdf_val, pdf):
        """brdf / pdf / MIS weighting (`ssgi.frag:252-259`)."""
        gi = gi * brdf_val[..., None]
        mis = brdf.mis_heuristic(ems_pdf, pdf)
        weight = torch.where(is_env_sample, mis, 1.0 / pdf)
        return gi * (weight / ems_pdf)[..., None]

    rays = p["rays"]
    # the specular ray gets the pixel's isDiffuseSample flag too, as in
    # the reference (`ssgi.frag:245-265`)
    spec_gi, spec_hit_pos, spec_brdf_v, spec_pdf_v = do_sample(
        rays[0], traces[0], is_diffuse_sample)
    specular_gi = finalize(spec_gi, spec_brdf_v, spec_pdf_v)
    if cfg.mode == "ssgi":
        diff_gi, _, diff_brdf_v, diff_pdf_v = do_sample(
            rays[1], traces[1], is_diffuse_sample)
        diffuse_gi = finalize(diff_gi, diff_brdf_v, diff_pdf_v)
        # pixels that did not take a diffuse sample mark -1 (`:277-278`)
        diffuse_gi = torch.where(is_diffuse_sample[..., None], diffuse_gi, -1.0)
    else:
        diffuse_gi = torch.full((h, w, 3), -1.0, device=dev)

    if cfg.use_direct_light:
        specular_gi = specular_gi + direct_light
        if cfg.mode == "ssgi":
            diffuse_gi = torch.where(is_diffuse_sample[..., None],
                                     diffuse_gi + direct_light, diffuse_gi)

    # world-space ray length for hit-point reprojection (`:282-296`)
    is_missed = spec_hit_pos[..., 0] > 1.0e8
    hit_ws = math3d.transform_point(cam.camera_matrix_world, spec_hit_pos)
    to_hit = torch.stack([hit_ws[..., i] - float(cam.position[i])
                          for i in range(3)], dim=-1)
    ray_length = torch.where(is_missed, 0.0, math3d.length(to_hit))

    g_diffuse = torch.cat([diffuse_gi, roughness[..., None]], dim=-1)
    g_specular = torch.cat([specular_gi, ray_length[..., None]], dim=-1)
    # the background shows the direct light (`ssgi.frag:108-113`)
    bg = torch.cat([direct_light, torch.zeros_like(depth)[..., None]], dim=-1)
    g_diffuse = torch.where(is_bg[..., None], bg, g_diffuse)
    g_specular = torch.where(is_bg[..., None], bg, g_specular)
    return g_diffuse, g_specular


def ssgi(gbuffer: GBuffer, velocity: VelocityBuffer,
         accumulated: torch.Tensor, direct_light: torch.Tensor,
         env: EquirectEnv | None, cam, frame: int, cfg: SSGIConfig,
         ray_distance: float = 10.0, thickness: float = 10.0,
         env_blur: float = 0.5):
    """One SSGI sample per pixel. ``accumulated`` is last frame's composed
    output (H, W, >=3), ``direct_light`` the lit scene colour (H, W, 3).
    Returns (g_diffuse (H, W, 4) = (diffuseGI | -1, roughness),
    g_specular (H, W, 4) = (specularGI, rayLength)) as `ssgi.frag:274-308`
    packs them."""
    if cfg.trace not in ("sweep", "march"):
        raise ValueError("trace must be 'march' or 'sweep'")
    sweep = cfg.trace == "sweep"
    spans = PASS_SPANS[cfg.mode]
    with tracing.span(spans["setup"]):
        p = _setup(gbuffer, env, cam, frame, cfg)
        bin_noise = _bin_noise(p, frame) if sweep else None
    depth = gbuffer.depth
    if sweep:
        with tracing.span(spans["prewarp"]):
            radiance = _prewarp(accumulated, velocity, p["uv"])
        with tracing.span(spans["trace"]):
            traces = sweep_ray_march(
                p["view_pos"], p["rays"], depth, cam, frame, thickness,
                ray_distance, dirs=cfg.sweep_dirs, steps=cfg.sweep_steps,
                bin_noise=bin_noise, radiance=radiance,
                miss_radiance=cfg.missed_rays)
        # freed before the shade, as arguments of the call would be
        del bin_noise, radiance
    else:
        with tracing.span(spans["trace"]), tracing.span(spans["march"]):
            traces = [view_space_ray_march(p["view_pos"], ray, depth, cam, p["r3"],
                                           thickness, ray_distance, cfg)
                      for ray in p["rays"]]
    with tracing.span(spans["shade"]):
        return _shade(p, traces, velocity.velocity, accumulated, direct_light,
                      env, cam, frame, cfg, env_blur)


def ssgi_split(sf, gbuffer: GBuffer, velocity: VelocityBuffer, accumulated,
               direct_light, env, cam, frame: int, cfg: SSGIConfig,
               ray_distance: float = 10.0, thickness: float = 10.0,
               env_blur: float = 0.5):
    """:func:`ssgi` in a split frame (``parallel.halo.SplitFrame`` ``sf``):
    the G-buffer, velocity, ``accumulated`` and ``direct_light`` as row
    blocks, the result as row blocks; the values of :func:`ssgi` on the
    whole frame.

    The trace reads at any distance, so its sources are gathered once
    (``replicate_for_rolls``). The sweep: each shard computes its rows'
    planes, view z and prewarped radiance (halo :data:`PREWARP_HALO`),
    the sweep kernel runs once on the composer's device over the
    gathered planes, and each shard finishes its rows from the split
    result. The march: each shard marches its rows against the gathered
    depth and reads the gathered velocity and composed output at the
    hits. The glue before and after runs per shard, halo-extended by
    ``env_fetch_stride - 1`` rows for the shared environment fetch."""
    from ..parallel.halo import device_scope

    if cfg.trace not in ("sweep", "march"):
        raise ValueError("trace must be 'march' or 'sweep'")
    fh, fw = sf.height, sf.width
    halo = max(cfg.env_fetch_stride - 1, 0) if cfg.trace == "sweep" else 0
    if cfg.trace == "march":
        sources = replicate_for_rolls(gbuffer.depth, velocity.velocity,
                                      accumulated, device=sf.home)

        def march(row0, gb, color, depth_src, vel_src, acc_src):
            p = _setup(gb, env, cam, frame, cfg, row0, fh)
            traces = [view_space_ray_march(p["view_pos"], ray, depth_src, cam,
                                           p["r3"], thickness, ray_distance, cfg)
                      for ray in p["rays"]]
            return _shade(p, traces, vel_src, acc_src, color, env, cam, frame,
                          cfg, env_blur)

        return sf.map(march, halo, gbuffer, direct_light, *sources)

    def planes(row0, gb, vel, acc):
        p = _setup(gb, env, cam, frame, cfg, row0, fh)
        z_tex, pl, _, _, _ = march_inputs(
            p["view_pos"], p["rays"], gb.depth, cam, frame, ray_distance,
            cfg.sweep_dirs, cfg.sweep_steps, bin_noise=_bin_noise(p, frame),
            frame_height=fh)
        return z_tex, pl.permute(1, 2, 0), _prewarp(acc, vel, p["uv"], row0, fh)

    z_b, pl_b, rad_b = sf.map(planes, PREWARP_HALO, gbuffer, velocity,
                              accumulated)
    z_tex, pl, radiance = replicate_for_rolls(z_b, pl_b, rad_b, device=sf.home)
    table, radii_prev, _ = step_table(int(frame), fh, fw, cfg.sweep_dirs,
                                      cfg.sweep_steps, MIN_RADIUS)
    with device_scope(sf.home):
        marched = sweep_march(z_tex, radiance, pl.permute(2, 0, 1).contiguous(),
                              table, radii_prev, thickness, ray_distance,
                              2 if cfg.mode == "ssgi" else 1, cfg.sweep_dirs, cfg.sweep_steps,
                              miss_gi=cfg.missed_rays)
    marched = sf.split([tuple(m) for m in marched])

    def finish(row0, gb, color, marched_):
        p = _setup(gb, env, cam, frame, cfg, row0, fh)
        per_ray = march_inputs(p["view_pos"], p["rays"], gb.depth, cam, frame,
                               ray_distance, cfg.sweep_dirs, cfg.sweep_steps,
                               frame_height=fh)[4]
        traces = sweep_results(p["view_pos"], p["rays"], per_ray, marched_,
                               fh, fw, ray_distance)
        return _shade(p, traces, None, None, color, env, cam, frame, cfg,
                      env_blur)

    return sf.map(finish, halo, gbuffer, direct_light, marched)
