"""Temporal reprojection + accumulation (`temporal_reproject.frag`,
`reproject.frag`): per-texture reprojection with the 5-tap Catmull-Rom
history fetch, 3-way disocclusion, neighborhood clamp, confidence-
weighted blend and effective-sample-count alpha.

History and disocclusion probes go through the window warp kernel
(``ops/warp.py``): a reprojection outside the +-window_ky / +-window_kx
window counts as a disocclusion. The clamp AABB comes from the minmax
kernel (``ops/stencil.py``).

CUDA tensors take ``ops/reproject_kernel.py``: two kernels of
``csrc/reproject.cu`` around the same fetches, bit for bit with
:func:`temporal_reproject_plain`, the CPU route.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from .. import tracing
from ..core import math3d
from ..core.framebuffers import VelocityBuffer
from ..core.math3d import (fwidth, length, mix, rdiv, screen_to_world,
                           transform_point, uv_grid)
from . import reproject_kernel
from .stencil import neighborhood_minmax
from .warp import catmull_rom5_window, nearest_window

# Disocclusion scale constants (`reproject.frag:107-109`)
_PLANE_DISTANCE = 20.0
_WORLD_DISTANCE = 10.0
_NORMAL_DISTANCE = 1.0

_MAX_ACC_ALPHA = 65536.0  # `temporal_reproject.frag:68`


@dataclasses.dataclass(frozen=True)
class TemporalReprojectConfig:
    """Define-like configuration; same fields and defaults as the JAX
    package's (``defaultTemporalReprojectPassOptions``,
    `TemporalReprojectPass.js:17-32`)."""

    texture_count: int = 1
    log_transform: bool = False
    reproject_specular: tuple = (False,)
    neighborhood_clamp: tuple = (True,)
    confidence_power: float = 0.75
    #: 'diffuse' | 'specular' | 'diffuse_specular'
    input_type: str = "diffuse"
    #: 3x3 closest-depth velocity dilation
    dilation: bool = False
    #: window of the warp fetches: +-window_ky rows x +-window_kx columns;
    #: reprojections beyond it are disocclusions
    window_ky: int = 8
    window_kx: int = 30


def halo_rows(cfg: TemporalReprojectConfig) -> int:
    """The vertical reach of :func:`temporal_reproject`: the warp window
    ``window_ky``, the Catmull-Rom footprint (2), the widest
    neighbourhood clamp (2) and ``fwidth``'s forward difference (1);
    with ``dilation``, 1 more."""
    return int(cfg.window_ky) + 2 + 2 + 1 + int(cfg.dilation)


def _transform_color(c, cfg):
    return torch.log(c + 1.0) if cfg.log_transform else c


def _undo_transform_color(c, cfg):
    return torch.exp(c) - 1.0 if cfg.log_transform else c


def _validate_reprojected_uv(reproj_uv, depth, world_pos, world_normal,
                             last_nd_packed, cam, prev_cam, cfg, rows):
    """Confidence from 3 disocclusion checks (`reproject.frag:130-167`).
    ``rows``: (row_offset, frame_height) of a row block."""
    in_bounds = ((reproj_uv[..., 0] >= 0.0) & (reproj_uv[..., 0] <= 1.0)
                 & (reproj_uv[..., 1] >= 0.0) & (reproj_uv[..., 1] <= 1.0))
    last_nd, in_win = nearest_window(last_nd_packed, reproj_uv,
                                     ky=cfg.window_ky, kx=cfg.window_kx,
                                     row_offset=rows[0], frame_height=rows[1])
    in_bounds = in_bounds & in_win
    last_normal = last_nd[..., :3]
    last_depth = last_nd[..., 3]
    last_world_pos = screen_to_world(reproj_uv, last_depth,
                                     prev_cam.camera_matrix_world,
                                     prev_cam.projection_matrix_inverse)
    view_z = math3d.depth_to_view_z(depth, cam).abs()
    dist_factor = 1.0 + rdiv(1.0, view_z + 1.0)

    to_current = world_pos - last_world_pos
    world_dist = length(to_current)
    plane_dist = math3d.dot(to_current, world_normal).abs()
    normal_dist = torch.clamp(1.0 - math3d.dot(world_normal, last_normal),
                              max=1.0)
    disoccl = (world_dist / _WORLD_DISTANCE * dist_factor
               + plane_dist / _PLANE_DISTANCE * dist_factor
               + normal_dist / _NORMAL_DISTANCE * dist_factor)
    confidence = torch.clamp(1.0 - torch.clamp(disoccl, max=1.0), min=0.0)
    confidence = confidence ** cfg.confidence_power
    return torch.where(in_bounds, confidence, 0.0)


def _reproject_hit_point(world_pos, ray_length, curvature, cam, prev_cam):
    """Specular parallax reprojection (`reproject.frag:169-193`).
    Returns (uv, valid)."""
    valid = (curvature <= 0.05) & (ray_length >= 0.01)
    cam_pos = tracing.to_device(cam.position, world_pos.device,
                                site="temporal_reproject.cam_pos")
    cam_ray = math3d.normalize(world_pos - cam_pos)
    hit_point = cam_pos + cam_ray * ray_length[..., None]
    view = transform_point(prev_cam.view_matrix, hit_point)
    clip, w = math3d.transform_point_nodiv(prev_cam.projection_matrix, view)
    safe_w = torch.where(w.abs() > 1e-8, w, 1e-8)
    return clip[..., :2] / safe_w[..., None] * 0.5 + 0.5, valid


def _neighborhood_minmax(tex, center_raw, radius: int):
    """AABB of the neighborhood seeded with the center input colour
    (`reproject.frag:53-81`)."""
    mn4, mx4 = neighborhood_minmax(tex.contiguous(), radius)
    return (torch.minimum(mn4[..., :3], center_raw),
            torch.maximum(mx4[..., :3], center_raw))


def _dilate_closest(buf: VelocityBuffer):
    """3x3 closest-depth dilation: each pixel takes the velocity, normal
    and depth of its minimum-depth neighbour (first wins on ties)."""
    h, w = buf.depth.shape
    pad = lambda a: torch.nn.functional.pad(
        a.permute(2, 0, 1)[None], (1, 1, 1, 1), mode="replicate")[0].permute(1, 2, 0)
    dp = pad(buf.depth[..., None])[..., 0]
    vp = pad(buf.velocity)
    np_ = pad(buf.normal)
    best_d, best_v, best_n = buf.depth, buf.velocity, buf.normal
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            sl = (slice(1 + dy, 1 + dy + h), slice(1 + dx, 1 + dx + w))
            d = dp[sl]
            closer = d < best_d
            best_v = torch.where(closer[..., None], vp[sl], best_v)
            best_n = torch.where(closer[..., None], np_[sl], best_n)
            best_d = torch.where(closer, d, best_d)
    return best_v, best_n, best_d


def temporal_reproject(
    inputs: Sequence[torch.Tensor],
    history: Sequence[torch.Tensor],
    velocity: VelocityBuffer,
    last_velocity: VelocityBuffer,
    cam,
    prev_cam,
    cfg: TemporalReprojectConfig,
    max_blend: float = 1.0,
    neighborhood_clamp_intensity: float = 1.0,
    full_accumulate: bool = False,
    keep_data: float = 1.0,
    roughness_tex=None,
    row_offset: int = 0,
    frame_height: int | None = None,
):
    """One temporal-reprojection step over ``texture_count`` slots.

    ``inputs[i]``/``history[i]``: (H, W, 4) rgb + alpha. Returns the list
    of new accumulated textures; alpha = effective sample count. The
    per-frame scalars (``max_blend``, ``keep_data``, ...) are host values.

    A row block of a larger frame passes its first row's global index
    ``row_offset`` and the frame's height; its rows are then exact where
    the block reaches :func:`halo_rows` rows past them on each side (the
    halo rows themselves are not).

    CUDA tensors launch ``ops/reproject_kernel.py``'s kernels around the
    fetches; CPU tensors take :func:`temporal_reproject_plain`.
    """
    route = (temporal_reproject_plain if velocity.depth.device.type == "cpu"
             else reproject_kernel.reproject)
    return route(inputs, history, velocity, last_velocity, cam, prev_cam, cfg,
                 max_blend=max_blend,
                 neighborhood_clamp_intensity=neighborhood_clamp_intensity,
                 full_accumulate=full_accumulate, keep_data=keep_data,
                 roughness_tex=roughness_tex, row_offset=row_offset,
                 frame_height=frame_height)


def temporal_reproject_plain(
    inputs: Sequence[torch.Tensor],
    history: Sequence[torch.Tensor],
    velocity: VelocityBuffer,
    last_velocity: VelocityBuffer,
    cam,
    prev_cam,
    cfg: TemporalReprojectConfig,
    max_blend: float = 1.0,
    neighborhood_clamp_intensity: float = 1.0,
    full_accumulate: bool = False,
    keep_data: float = 1.0,
    roughness_tex=None,
    row_offset: int = 0,
    frame_height: int | None = None,
):
    """:func:`temporal_reproject` in torch elementwise operations around
    the fetches: the CPU route, and the reference the kernels are held
    to."""
    if not len(inputs) == cfg.texture_count == len(history):
        raise ValueError("inputs, history and texture_count disagree")
    h, w = velocity.depth.shape
    dev = velocity.depth.device
    fh = h if frame_height is None else int(frame_height)
    rows = (row_offset, fh)
    uv = uv_grid(h, w, dev, row_offset, fh)

    if cfg.dilation:
        vel, world_normal, depth = _dilate_closest(velocity)
    else:
        vel, world_normal, depth = (velocity.velocity, velocity.normal,
                                    velocity.depth)

    curvature = length(fwidth(world_normal, row_offset, fh))
    world_pos = screen_to_world(uv, depth, cam.camera_matrix_world,
                                cam.projection_matrix_inverse)

    # roughness / rayLength (`temporal_reproject.frag:167-176`)
    if cfg.input_type == "diffuse_specular":
        ray_length = inputs[1][..., 3]
        roughness = torch.clamp(inputs[0][..., 3], 0.0, 1.0)
    elif cfg.input_type == "specular":
        ray_length = inputs[0][..., 3]
        roughness = (torch.clamp(roughness_tex, 0.0, 1.0)
                     if roughness_tex is not None
                     else torch.ones_like(ray_length))
    else:
        ray_length = torch.zeros_like(depth)
        roughness = torch.ones_like(depth)

    move_factor = torch.clamp((vel * vel).sum(-1) * 10000.0, max=1.0)

    last_nd_packed = torch.cat([last_velocity.normal,
                                last_velocity.depth[..., None]], dim=-1)
    diffuse_uv = uv - vel
    diffuse_conf = _validate_reprojected_uv(
        diffuse_uv, depth, world_pos, world_normal, last_nd_packed, cam,
        prev_cam, cfg, rows)

    if any(cfg.reproject_specular):
        hit_uv, hit_valid = _reproject_hit_point(world_pos, ray_length,
                                                 curvature, cam, prev_cam)
        spec_conf = _validate_reprojected_uv(
            hit_uv, depth, world_pos, world_normal, last_nd_packed, cam,
            prev_cam, cfg, rows)
        specular_uv = torch.where(hit_valid[..., None], hit_uv, diffuse_uv)
        specular_conf = torch.where(hit_valid, spec_conf, diffuse_conf)
    else:
        specular_uv, specular_conf = diffuse_uv, diffuse_conf

    max_value = (1.0 if full_accumulate else float(max_blend)) * float(keep_data)
    outputs = []
    for i in range(cfg.texture_count):
        is_spec = cfg.reproject_specular[i]
        reproj_uv = specular_uv if is_spec else diffuse_uv
        confidence = specular_conf if is_spec else diffuse_conf

        inp = inputs[i]
        sampled = inp[..., 0] >= 0.0
        inp_rgb = _transform_color(torch.clamp(inp[..., :3], min=0.0), cfg)

        # reproject (`temporal_reproject.frag:83-122`): the rgba16f
        # history through the 5-tap Catmull-Rom window fetch
        acc, _ = catmull_rom5_window(history[i], reproj_uv,
                                     ky=cfg.window_ky, kx=cfg.window_kx,
                                     row_offset=row_offset, frame_height=fh)
        acc_rgb = _transform_color(acc[..., :3], cfg)
        acc_rgb_raw = acc_rgb
        acc_a = acc[..., 3] + 1.0

        center = _undo_transform_color(inp_rgb, cfg)
        if is_spec:
            mn1, mx1 = _neighborhood_minmax(inp, center, 1)
            mn2, mx2 = _neighborhood_minmax(inp, center, 2)
            use1 = (roughness < 0.25)[..., None]
            mn = torch.where(use1, mn1, mn2)
            mx = torch.where(use1, mx1, mx2)
        else:
            mn, mx = _neighborhood_minmax(inp, center, 2)
        mn = _transform_color(mn, cfg)
        mx = _transform_color(mx, cfg)
        clamped = torch.minimum(torch.maximum(acc_rgb, mn), mx)

        r = roughness if is_spec else torch.ones_like(roughness)
        clamp_aggr = torch.clamp(confidence * r, max=1.0)
        clamp_intensity = torch.clamp(
            move_factor * 50.0 + float(neighborhood_clamp_intensity),
            max=1.0) * clamp_aggr
        new_rgb = mix(acc_rgb, clamped, clamp_intensity[..., None])
        color_diff = torch.clamp(length(new_rgb - acc_rgb), max=1.0)
        acc_a = acc_a * (1.0 - color_diff)
        acc_rgb = new_rgb

        # nothing sampled this frame: the input IS the unclamped history
        # (`temporal_reproject.frag:94-97`); alpha not incremented
        inp_rgb = torch.where(sampled[..., None], inp_rgb, acc_rgb_raw)
        acc_rgb = torch.where(sampled[..., None], acc_rgb, acc_rgb_raw)
        acc_a = torch.where(sampled, acc_a, acc[..., 3])

        # accumulate (`temporal_reproject.frag:42-79`)
        conf2 = confidence ** cfg.confidence_power  # pow applied twice upstream
        accum_blend = (1.0 - rdiv(1.0, acc_a + 1.0)) * conf2
        mv = torch.full_like(accum_blend, max_value)
        if cfg.input_type != "diffuse" and is_spec:
            roughness_maximum = 0.1
            low_rough = (roughness >= 0.0) & (roughness < roughness_maximum)
            max_rough_value = mv * (roughness / roughness_maximum)
            gated = mix(mv, max_rough_value,
                        torch.clamp(100.0 * move_factor, max=1.0))
            mv = torch.where(low_rough, gated, mv)

        t = torch.minimum(accum_blend, mv)
        out_a = torch.clamp(rdiv(1.0, 1.0 - t) - 1.0, max=_MAX_ACC_ALPHA)
        out_rgb = _undo_transform_color(mix(inp_rgb, acc_rgb, t[..., None]),
                                        cfg)
        outputs.append(torch.cat([out_rgb, out_a[..., None]], dim=-1))
    return outputs
