"""Ambient occlusion: HBAO (`hbao.frag` + `hbao_utils.glsl`) and GTAO
(`gtao.frag`).

HBAO has two formulations, as in the JAX package: by default the whole
per-pixel loop runs in the fused HBAO kernel (``ops/hbao_kernel.py``);
with :data:`USE_FUSED_KERNEL` off, the JAX package's unfused one runs in
torch ops, its spp depth taps resolved by one multi-target window fetch
(``ops/warp.py::window_warp_multi``). GTAO runs in torch ops (the JAX
package has no Pallas kernel for it): per sample, one nearest fetch of a
9-channel depth stencil gives the sample's depth and its depth-derived
normal.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import tracing
from ..core import math3d
from ..core.brdf import cosine_sample_hemisphere, hemisphere_basis
from ..core.math3d import floor_int32, screen_to_world, smoothstep, uv_grid
from ..core.rng import blue_noise_image, vogel_disk
from ..core.sampling import sample_nearest
from .hbao_kernel import hbao_fused
from .warp import window_warp_multi

#: run HBAO through the fused kernel; off, through the unfused
#: formulation (the JAX package's ``ops/ao.py`` switch of the same name)
USE_FUSED_KERNEL = True

#: GTAO's 16 samples, the reference's literal table (`gtao.frag:69-75`):
#: a shuffled Vogel distribution baked into the shader
VOGEL16 = np.array(
    [
        (0.030909661398755346, -0.35219964910859053),
        (0.24815307104280765, 0.7911510938702059),
        (-0.18434221951957994, 0.16887257356538096),
        (0.47167354889397395, -0.30004010277588555),
        (0.2634617551286817, 0.3436392055405124),
        (-0.12442994035028206, -0.9602172618446438),
        (-0.49235674265771434, -0.08709097518965582),
        (-0.15897452050963823, 0.5913772922836407),
        (-0.6932591671033536, 0.2861673063562022),
        (0.0, 0.0),
        (0.6642004583437224, 0.24256494210002652),
        (-0.5379843192229464, 0.7652273337186949),
        (0.8803636453299621, -0.19354547781165166),
        (0.33507968037296143, -0.7160458140378687),
        (-0.30486134122856906, -0.586991961294461),
        (-0.7492948872853635, -0.4342317029973909),
    ],
    np.float32,
)


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
    px = tracing.to_device([1.0 / w, 0.0], depth.device, site="ao.px")
    py = tracing.to_device([0.0, 1.0 / h], depth.device, site="ao.py")
    dpdx = torch.where((dl < dr)[..., None], ce - world_pos(l1, uv - px),
                       world_pos(r1, uv + px) - ce)
    dpdy = torch.where((db < dt)[..., None], ce - world_pos(b1, uv - py),
                       world_pos(t1, uv + py) - ce)
    return math3d.normalize(torch.linalg.cross(dpdx, dpdy))


def hbao(depth: torch.Tensor, normal: torch.Tensor | None, cam, frame: int,
         cfg: AOConfig, row_offset: int = 0, frame_height: int | None = None):
    """HBAO. Returns (world normal (H, W, 3), ao (H, W)).

    ``normal``: world normals (G-buffer); None selects the depth-derived
    normals (`hbao_utils.glsl:70-79`). A row block of a larger frame
    passes its first row's global index ``row_offset`` and the frame's
    height; that takes the fused kernel and the G-buffer's normals."""
    if frame_height is not None:
        if not (USE_FUSED_KERNEL and normal is not None and cfg.use_normal_texture):
            raise ValueError("a row block of HBAO runs the fused kernel on "
                             "the G-buffer's normals")
        return normal, hbao_fused(depth, normal, cam, frame, cfg, row_offset,
                                  frame_height)
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

    cam_pos = tracing.to_device(cam.position, dev, torch.float32, "ao.cam_pos")
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


def _pack_depth_stencil(depth: torch.Tensor) -> torch.Tensor:
    """(H, W, 9): the 9-tap normal-reconstruction depth stencil
    [c0, l1, l2, r1, r2, b1, b2, t1, t2] as channels, the shifts clamped
    at the edges, so one nearest fetch of this plane hands a GTAO sample
    its depth and every value its normal needs."""
    h, w = depth.shape
    pad = torch.nn.functional.pad(depth[None, None], (2, 2, 2, 2),
                                  mode="replicate")[0, 0]
    sh = lambda dy, dx: pad[2 + dy: 2 + dy + h, 2 + dx: 2 + dx + w]
    return torch.stack([depth, sh(0, -1), sh(0, -2), sh(0, 1), sh(0, 2),
                        sh(-1, 0), sh(-2, 0), sh(1, 0), sh(2, 0)], dim=-1)


def _depth_world_normals_at(stencil9: torch.Tensor, uv: torch.Tensor, cam):
    """Depth-derived normals at any ``uv`` (`gtao.frag:110`): the depth
    values are nearest fetches of :func:`_pack_depth_stencil`'s plane
    (three.js's ``DepthTexture`` filter), the reconstruction uses the
    continuous ``uv`` as `hbao_utils.glsl:46-52` does. Returns
    (normal (..., 3), centre depth)."""
    h, w = stencil9.shape[0], stencil9.shape[1]
    s = sample_nearest(stencil9, uv)
    c0 = s[..., 0]
    l1, l2, r1, r2 = s[..., 1], s[..., 2], s[..., 3], s[..., 4]
    b1, b2, t1, t2 = s[..., 5], s[..., 6], s[..., 7], s[..., 8]
    dl = (2.0 * l1 - l2 - c0).abs()
    dr = (2.0 * r1 - r2 - c0).abs()
    db = (2.0 * b1 - b2 - c0).abs()
    dt = (2.0 * t1 - t2 - c0).abs()

    def world_pos(d, uvx):
        return screen_to_world(uvx, d, cam.camera_matrix_world,
                               cam.projection_matrix_inverse)

    px = tracing.to_device([1.0 / w, 0.0], uv.device, site="ao.gtao_px")
    py = tracing.to_device([0.0, 1.0 / h], uv.device, site="ao.gtao_py")
    ce = world_pos(c0, uv)
    dpdx = torch.where((dl < dr)[..., None], ce - world_pos(l1, uv - px),
                       world_pos(r1, uv + px) - ce)
    dpdy = torch.where((db < dt)[..., None], ce - world_pos(b1, uv - py),
                       world_pos(t1, uv + py) - ce)
    return math3d.normalize(torch.linalg.cross(dpdx, dpdy)), c0


def gtao(depth: torch.Tensor, cam, frame: int, cfg: AOConfig) -> torch.Tensor:
    """GTAO (`gtao.frag:77-125`): Vogel-disk hemisphere samples around the
    depth-derived normal, occlusion by the depth difference to the 4th
    power and the dot of the two normals. ``cfg.spp`` sets the sample
    count (16, the default of ``GTAOEffect``, takes the reference's
    table :data:`VOGEL16`) and ``cfg.distance`` scales the radius (0.25
    at the default 2.0); ``bias``, ``thickness`` and ``distance_power``
    are unused, as upstream. Returns ao (H, W), 1 on the background."""
    h, w = depth.shape
    dev = depth.device
    uv = uv_grid(h, w, dev)
    normal = depth_world_normals(depth, cam)
    world_pos = screen_to_world(uv, depth, cam.camera_matrix_world,
                                cam.projection_matrix_inverse)
    view_z = math3d.depth_to_view_z(depth, cam).abs()

    n_samples = cfg.spp if cfg.spp > 0 else 16
    vogel = VOGEL16 if n_samples == 16 else vogel_disk(n_samples)
    radius = 0.25 * (cfg.distance / 2.0)
    stencil9 = _pack_depth_stencil(depth)
    # the cosine-weighted frame around the normal, the same every sample
    b, t = hemisphere_basis(normal)
    base = frame if cfg.animated_noise else 0
    ao = torch.zeros_like(depth)
    for i in range(n_samples):
        noise = blue_noise_image(h, w, base * n_samples + i, device=dev)
        # a sample's two uniforms are one Vogel point for every pixel, so
        # its three weights are float32 scalars, the sine and cosine
        # rounded from float64 on the host: the card and the CPU take the
        # same ones
        u0, u1 = vogel[i] * np.float32(0.5) + np.float32(0.5)
        r = np.sqrt(u0)
        theta = np.float32(2.0 * math.pi) * u1
        k1 = float(r * np.float32(np.sin(np.float64(theta))))
        k2 = float(np.sqrt(np.maximum(np.float32(1.0) - u0, np.float32(0.0))))
        k3 = float(r * np.float32(np.cos(np.float64(theta))))
        sample_dir = math3d.normalize(k1 * b + k2 * normal + k3 * t)
        sample_pos = world_pos + 4.0 * noise[..., 0:1] * radius * sample_dir
        clip, cw = math3d.transform_point_nodiv(cam.projection_view_matrix,
                                                sample_pos)
        safe_w = torch.where(cw.abs() > 1e-8, cw, 1e-8)
        sample_uv = clip[..., :2] / safe_w[..., None] * 0.5 + 0.5
        sample_normal, sample_depth = _depth_world_normals_at(stencil9,
                                                              sample_uv, cam)
        sample_view_z = math3d.depth_to_view_z(sample_depth, cam).abs()
        # x ** 4.0 rounded once, as XLA's pow (torch's pow(x, 4.0) is off
        # by an ulp more often)
        depth_diff = (torch.clamp(view_z - sample_view_z, min=0.0).double()
                      ** 4).float()
        normal_dot = math3d.dot(normal, sample_normal)
        ao = ao + smoothstep(0.0, 1.0, 1.0 - depth_diff) * normal_dot
    ao = ao / float(n_samples)
    return torch.where(depth >= 1.0, 1.0, torch.clamp(ao, 0.0, 1.0))
