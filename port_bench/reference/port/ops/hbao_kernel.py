"""Fused HBAO: the whole per-pixel AO loop in one kernel.

The plain version of the port's kernel ``csrc/hbao.cu``, which replaces
the JAX package's
``ops/pallas/hbao.py::_hbao_kernel`` (``hbao_fused``), whose semantics
are those of ``ops/ao.py::hbao`` with the window-clamped sampling radius
(`hbao.frag:80-115`): per pixel the world position, spp cosine-weighted
directions from the blue-noise tile, the projected sample, its depth
fetched nearest within +-ky rows / +-kx columns, and the horizon
occlusion integral. The port's kernel takes any window (the TPU's
ky <= 64, kx <= 32 were VMEM and lane limits) and any spp: the noise
shifts ride in the launch's parameters 32 samples at a time, and above
32 samples the kernel is launched once a chunk of 32 with the running
sums carried between launches in a (2, H, W) scratch, in the same
summation order as one launch.

A row block of a larger frame takes ``row_offset`` (the global row of
its first row) and ``height`` (the global rows), as the JAX kernel's
``_ROW0`` and global ``h`` do: the uv, the sample row and its frame
clamp are the global frame's, the target is re-based onto the block,
and the noise shifts are rolled by the offset.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.rng import blue_noise_tile_tensor, noise_shift

_PI2 = float(np.float32(2.0 * math.pi))


def sample_indices(spp: int, frame: int, animated: bool) -> list[int]:
    """Noise index of each sample: ``frame * spp + s`` (the reference
    advances its frame counter by spp a frame, `AOPass.js:86-88`)."""
    base = frame * spp if animated else 0
    return [base + s for s in range(spp)]


def _host_params(cam, cfg, h: int, w: int) -> np.ndarray:
    f32 = lambda v: np.float32(v)
    return np.concatenate([
        np.asarray(cam.projection_matrix_inverse, np.float32).reshape(-1),
        np.asarray(cam.camera_matrix_world, np.float32).reshape(-1),
        np.asarray(cam.projection_view_matrix, np.float32).reshape(-1),
        np.asarray(cam.position, np.float32).reshape(-1),
        np.array([f32(cfg.distance), f32(cfg.distance_power + 1.0),
                  f32(cfg.bias), f32(cfg.thickness * 0.01),
                  f32(1.0 / w), f32(1.0 / h)], np.float32),
    ]).astype(np.float32)


def _row(m, i, x, y, z):
    return (float(m[i, 0]) * x + float(m[i, 1]) * y + float(m[i, 2]) * z
            + float(m[i, 3]))


def _tpoint(m, x, y, z):
    r = [_row(m, i, x, y, z) for i in range(4)]
    return r[0] / r[3], r[1] / r[3], r[2] / r[3]


def hbao_fused_plain(depth, normal, cam, frame: int, cfg, row_offset: int = 0,
                     height: int | None = None) -> torch.Tensor:
    """The kernel's function in PyTorch, op for op, on a row block of a
    frame of ``height`` rows (default: the block's) starting at global
    row ``row_offset``."""
    h, w = depth.shape
    hg = h if height is None else int(height)
    dev = depth.device
    ky, kx = int(cfg.window_ky), int(cfg.window_kx)
    prm = _host_params(cam, cfg, hg, w)
    dist_k, pow1, bias, th, inv_w, inv_h = (float(v) for v in prm[51:57])
    pv = np.asarray(cam.projection_view_matrix, np.float32)
    cpos = [float(v) for v in prm[48:51]]
    rr = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(h, w)
    cc = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(h, w)
    rg = rr + row_offset
    uvx = (cc.to(torch.float32) + 0.5) * inv_w
    uvy = (rg.to(torch.float32) + 0.5) * inv_h
    wpx, wpy, wpz = _tpoint(
        cam.camera_matrix_world,
        *_tpoint(cam.projection_matrix_inverse, (uvx - 0.5) * 2.0,
                 (uvy - 0.5) * 2.0, (depth - 0.5) * 2.0))
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    bias_k = float(np.float32(bias) * np.float32(1000.0))
    bx, by, bz = ny - nz, -nx, nx
    binv = torch.rsqrt(bx * bx + by * by + bz * bz)
    bx, by, bz = bx * binv, by * binv, bz * binv
    tx_ = by * nz - bz * ny
    ty_ = bz * nx - bx * nz
    tz_ = bx * ny - by * nx
    # the frame's row bounds and, for a block's halo rows, the block's
    dy_lo = torch.maximum(-rg, -rr)
    dy_hi = torch.minimum((hg - 1) - rg, (h - 1) - rr)
    tile = blue_noise_tile_tensor(dev)
    flat = depth.reshape(-1)
    ao = torch.zeros_like(depth)
    tw = torch.zeros_like(depth)
    for index in sample_indices(cfg.spp, frame, cfg.animated_noise):
        sy, sx = noise_shift(index, row_offset=row_offset)
        u = tile[((rr + sy) % 128).long(), ((cc + sx) % 128).long()]
        u0, u1, u2 = u[..., 0], u[..., 1], u[..., 2]
        r_ = torch.sqrt(u0)
        theta = u1 * _PI2
        k1 = r_ * torch.sin(theta)
        k2 = torch.sqrt(torch.clamp(1.0 - u0, min=0.0))
        k3 = r_ * torch.cos(theta)
        dx_ = k1 * bx + k2 * nx + k3 * tx_
        dy_ = k1 * by + k2 * ny + k3 * ty_
        dz_ = k1 * bz + k2 * nz + k3 * tz_
        dinv = torch.rsqrt(dx_ * dx_ + dy_ * dy_ + dz_ * dz_)
        dx_, dy_, dz_ = dx_ * dinv, dy_ * dinv, dz_ * dinv
        dist = dist_k * torch.exp(torch.log(u2) * pow1)
        spx = wpx + dist * dx_
        spy = wpy + dist * dy_
        spz = wpz + dist * dz_
        cxv, cyv, cwv = (_row(pv, i, spx, spy, spz) for i in (0, 1, 3))
        safe_w = torch.where(cwv.abs() > 1e-8, cwv, 1e-8)
        sux = cxv / safe_w * 0.5 + 0.5
        suy = cyv / safe_w * 0.5 + 0.5
        sux = torch.where(sux == sux, torch.clamp(sux, -2.0, 3.0), 0.0)
        suy = torch.where(suy == suy, torch.clamp(suy, -2.0, 3.0), 0.0)
        ixt = torch.floor(sux * float(w)).to(torch.int32)
        iyt = torch.floor(suy * float(hg)).to(torch.int32)
        dyv = torch.clamp(iyt - rg, -ky, ky)
        dyv = torch.minimum(torch.maximum(dyv, dy_lo), dy_hi)
        dyv = torch.clamp(dyv, -ky, ky)
        dxk = torch.clamp(torch.clamp(ixt, 0, w - 1) - cc, -kx, kx)
        sd = flat[((rr + dyv) * w + cc + dxk).long()]

        theta_n = nx * dx_ + ny * dy_ + nz * dz_
        ddx, ddy, ddz = spx - cpos[0], spy - cpos[1], spz - cpos[2]
        dd = torch.sqrt(ddx * ddx + ddy * ddy + ddz * ddz)
        delta = (depth - sd) * 0.001 * dd * dd
        tw = tw + theta_n
        horizon = sd + delta * bias_k
        occl = torch.clamp(horizon - depth, min=0.0) * theta_n
        m = torch.clamp(1.0 - delta / th, min=0.0)
        occl = torch.sqrt(torch.clamp(
            10.0 * occl * m / torch.clamp(dd, min=1e-6), min=0.0))
        ao = ao + torch.where(delta < th, occl, 0.0)
    ao = torch.where(tw > 0.0, ao / tw, ao)
    ao = torch.clamp(1.0 - ao, 0.0, 1.0)
    return torch.where(depth >= 1.0, 1.0, ao)


def hbao_fused(depth: torch.Tensor, normal: torch.Tensor, cam, frame: int,
               cfg, row_offset: int = 0,
               frame_height: int | None = None) -> torch.Tensor:
    """Fused HBAO: the AO plane (H, W) of ``depth`` (H, W) and world
    normals ``normal`` (H, W, 3). A row block of a larger frame passes
    its first row's global index ``row_offset`` and the frame's height
    (its rows are exact where it reaches ``cfg.window_ky`` rows past
    them)."""
    h = int(depth.shape[0])
    return hbao_fused_plain(depth, normal, cam, frame, cfg, row_offset,
                            h if frame_height is None else frame_height)
