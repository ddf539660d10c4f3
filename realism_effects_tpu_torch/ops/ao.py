"""Ambient occlusion: HBAO (`hbao.frag` + `hbao_utils.glsl`).

Two formulations, as in the JAX package: by default the whole per-pixel
loop runs in the fused HBAO kernel (``ops/hbao_kernel.py``); with
:data:`USE_FUSED_KERNEL` off, the JAX package's unfused one runs in torch
ops, its spp depth taps resolved by one multi-target window fetch
(``ops/warp.py::window_warp_multi``). GTAO is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import math3d
from ..core.brdf import cosine_sample_hemisphere
from ..core.math3d import floor_int32, screen_to_world, uv_grid
from ..core.rng import blue_noise_image
from .hbao_kernel import hbao_fused
from .warp import window_warp_multi

#: run HBAO through the fused kernel; off, through the unfused
#: formulation (the JAX package's ``ops/ao.py`` switch of the same name)
USE_FUSED_KERNEL = True


@dataclasses.dataclass(frozen=True)
class AOConfig:
    """Static knobs; same fields and defaults as the JAX package's
    (``defaultAOOptions``, `AOEffect.js:8-21`)."""

    spp: int = 8
    distance: float = 2.0
    distance_power: float = 1.0
    bias: float = 40.0
    thickness: float = 0.075
    animated_noise: bool = True
    #: use G-buffer normals instead of depth-derived ones
    use_normal_texture: bool = True
    #: sampling window of the depth taps, +-window_ky rows x +-window_kx
    #: columns: a sample beyond it fetches at the window edge (the
    #: sampling radius is clamped in screen space)
    window_ky: int = 32
    window_kx: int = 32


def depth_world_normals(depth: torch.Tensor, cam) -> torch.Tensor:
    """World normals from the depth buffer via the 9-tap curvature-aware
    stencil (`hbao_utils.glsl:46-68`). Returns (H, W, 3)."""
    h, w = depth.shape
    uv = uv_grid(h, w, depth.device)

    def world_pos(d, uvx):
        return screen_to_world(uvx, d, cam.camera_matrix_world,
                               cam.projection_matrix_inverse)

    pad = torch.nn.functional.pad(depth[None, None], (2, 2, 2, 2),
                                  mode="replicate")[0, 0]
    sh = lambda dy, dx: pad[2 + dy: 2 + dy + h, 2 + dx: 2 + dx + w]
    c0 = depth
    l1, l2 = sh(0, -1), sh(0, -2)
    r1, r2 = sh(0, 1), sh(0, 2)
    b1, b2 = sh(-1, 0), sh(-2, 0)
    t1, t2 = sh(1, 0), sh(2, 0)
    dl = (2.0 * l1 - l2 - c0).abs()
    dr = (2.0 * r1 - r2 - c0).abs()
    db = (2.0 * b1 - b2 - c0).abs()
    dt = (2.0 * t1 - t2 - c0).abs()

    ce = world_pos(c0, uv)
    px = torch.tensor([1.0 / w, 0.0], device=depth.device)
    py = torch.tensor([0.0, 1.0 / h], device=depth.device)
    dpdx = torch.where((dl < dr)[..., None], ce - world_pos(l1, uv - px),
                       world_pos(r1, uv + px) - ce)
    dpdy = torch.where((db < dt)[..., None], ce - world_pos(b1, uv - py),
                       world_pos(t1, uv + py) - ce)
    return math3d.normalize(torch.linalg.cross(dpdx, dpdy))


def hbao(depth: torch.Tensor, normal: torch.Tensor | None, cam, frame: int,
         cfg: AOConfig):
    """HBAO. Returns (world normal (H, W, 3), ao (H, W)).

    ``normal``: world normals (G-buffer); None selects the depth-derived
    normals (`hbao_utils.glsl:70-79`)."""
    if normal is None or not cfg.use_normal_texture:
        world_normal = depth_world_normals(depth, cam)
    else:
        world_normal = normal
    if USE_FUSED_KERNEL:
        return world_normal, hbao_fused(depth, world_normal, cam, frame, cfg)
    return world_normal, hbao_unfused(depth, world_normal, cam, frame, cfg)


def hbao_unfused(depth: torch.Tensor, world_normal: torch.Tensor, cam,
                 frame: int, cfg: AOConfig) -> torch.Tensor:
    """The AO plane (H, W) in the JAX package's unfused formulation and
    operation order (``ops/ao.py:215-287``): per sample the blue-noise
    image, a cosine-weighted direction and distance, the projected uv;
    the horizontal target clamped to +-window_kx, all spp depth taps in
    one :func:`window_warp_multi`; then the horizon integral."""
    h, w = depth.shape
    dev = depth.device
    world_pos = screen_to_world(uv_grid(h, w, dev), depth,
                                cam.camera_matrix_world,
                                cam.projection_matrix_inverse)
    base = frame * cfg.spp if cfg.animated_noise else 0
    dirs, positions, uvs = [], [], []
    for i in range(cfg.spp):
        noise = blue_noise_image(h, w, base + i, device=dev)
        sample_dir = cosine_sample_hemisphere(world_normal, noise[..., :2])
        dist = cfg.distance * noise[..., 2] ** (cfg.distance_power + 1.0)
        sample_pos = world_pos + dist[..., None] * sample_dir
        clip, cw = math3d.transform_point_nodiv(cam.projection_view_matrix,
                                                sample_pos)
        safe_w = torch.where(cw.abs() > 1e-8, cw, 1e-8)
        uvs.append(clip[..., :2] / safe_w[..., None] * 0.5 + 0.5)
        dirs.append(sample_dir)
        positions.append(sample_pos)

    uvs = torch.stack(uvs)
    ix = floor_int32(uvs[..., 0] * w)
    iy = floor_int32(uvs[..., 1] * h)
    xs = torch.arange(w, dtype=torch.int32, device=dev)
    ix = xs + torch.clamp(torch.clamp(ix, 0, w - 1) - xs,
                          -cfg.window_kx, cfg.window_kx)
    sample_depths, _ = window_warp_multi(depth, iy, ix, ky=cfg.window_ky,
                                         kx=cfg.window_kx)

    cam_pos = torch.as_tensor(cam.position, dtype=torch.float32, device=dev)
    th = cfg.thickness * 0.01
    ao = torch.zeros_like(depth)
    total_weight = torch.zeros_like(depth)
    for sample_dir, sample_pos, sample_depth in zip(dirs, positions,
                                                    sample_depths):
        d = math3d.length(sample_pos - cam_pos)
        delta_depth = (depth - sample_depth) * 0.001 * d * d
        theta = math3d.dot(world_normal, sample_dir)
        total_weight = total_weight + theta
        horizon = sample_depth + delta_depth * cfg.bias * 1000.0
        occlusion = torch.clamp(horizon - depth, min=0.0) * theta
        m = torch.clamp(1.0 - delta_depth / th, min=0.0)
        occlusion = torch.sqrt(torch.clamp(
            10.0 * occlusion * m / torch.clamp(d, min=1e-6), min=0.0))
        ao = ao + torch.where(delta_depth < th, occlusion, 0.0)
    ao = torch.where(total_weight > 0.0, ao / total_weight, ao)
    ao = torch.clamp(1.0 - ao, 0.0, 1.0)
    return torch.where(depth >= 1.0, 1.0, ao)
