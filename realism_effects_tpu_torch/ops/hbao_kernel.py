"""Fused HBAO: the whole per-pixel AO loop in one kernel.

Kernel: ``csrc/hbao.cu``. It replaces the JAX package's
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
and the noise shifts are rolled by the offset. The split frame's shards
run it so on their rows extended by ``window_ky`` rows of depth
(exchanged) and of normals (edge-padded: only the centre pixel's normal
is read).

On the H100 the kernel is bound by instruction issue against 20 bytes
a pixel. The cosine draw of a sample (sqrt, sin, cos, sqrt, exp(log))
depends on the blue-noise texel and two launch constants only, so a
small kernel computes it once per tile texel into a (128, 128, 4) table
of (k1, k2, k3, dist) (``noise_table``, kept per device, distance and
power: a frame launches nothing more), and the per-sample loop reads one
float4 of it; what is left a sample is the direction's normalisation,
the projection, the depth fetch and the integral (four IEEE divisions,
three square roots). A background pixel (depth >= 1), whose AO is 1
whatever its samples, stops after its depth load. One thread per pixel,
all in registers; the sample depths are direct loads served by L1/L2.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.rng import blue_noise_tile_tensor, noise_shift
from . import cuda_build

_PI2 = float(np.float32(2.0 * math.pi))
_CHUNK = 32  # samples a launch takes (csrc/hbao.cu kChunk)


def sample_indices(spp: int, frame: int, animated: bool) -> list[int]:
    """Noise index of each sample: ``frame * spp + s`` (the reference
    advances its frame counter by spp a frame, `AOPass.js:86-88`)."""
    base = frame * spp if animated else 0
    return [base + s for s in range(spp)]


def rolled_noise_tiles(spp: int, frame: int, animated: bool,
                       device=None) -> torch.Tensor:
    """(3*spp, 128, 128): channel triple ``3s .. 3s+2`` is blue-noise
    image ``frame*spp + s`` (channels 0..2) at ``[y % 128, x % 128]``."""
    tile = blue_noise_tile_tensor(device or "cpu")[..., :3]
    outs = []
    for index in sample_indices(spp, frame, animated):
        sy, sx = noise_shift(index)
        rolled = torch.roll(tile, shifts=(-sy, -sx), dims=(0, 1))
        outs.append(rolled.permute(2, 0, 1))
    return torch.cat(outs, dim=0)


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


def noise_table_plain(tile: torch.Tensor, distance: float,
                      pow1: float) -> torch.Tensor:
    """The noise table's function in PyTorch: (128, 128, 4) float32
    (k1, k2, k3, dist) of the (128, 128, 4) blue-noise ``tile``."""
    u0, u1, u2 = tile[..., 0], tile[..., 1], tile[..., 2]
    r_ = torch.sqrt(u0)
    theta = u1 * _PI2
    return torch.stack([
        r_ * torch.sin(theta), torch.sqrt(torch.clamp(1.0 - u0, min=0.0)),
        r_ * torch.cos(theta),
        float(np.float32(distance)) * torch.exp(torch.log(u2) * float(np.float32(pow1)))],
        -1)


def noise_table(device, distance: float, pow1: float) -> torch.Tensor:
    """The HBAO kernel's (128, 128, 4) noise table for ``distance`` and
    ``pow1`` (``distance_power + 1``), both as float32, on a CUDA
    ``device``: built by its kernel once per (device, distance, pow1)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _noise_table(str(dev), float(np.float32(distance)),
                        float(np.float32(pow1)))


@functools.lru_cache(maxsize=8)
def _noise_table(device: str, distance: float, pow1: float) -> torch.Tensor:
    tile = blue_noise_tile_tensor(device)
    table = torch.empty_like(tile)
    kparams = np.array([distance, pow1], np.float32)
    cuda_build.launch("hbao_noise", "hbao", "re_hbao_noise", (2, 0, 1), tile,
                      tile.data_ptr(), table.data_ptr(), kparams.ctypes.data)
    if table.is_cuda:
        # built once, read by launches on any stream: finish it here
        torch.cuda.current_stream(table.device).synchronize()
    return table


def hbao_fused(depth: torch.Tensor, normal: torch.Tensor, cam, frame: int,
               cfg, row_offset: int = 0,
               frame_height: int | None = None) -> torch.Tensor:
    """Fused HBAO: the AO plane (H, W) of ``depth`` (H, W) and world
    normals ``normal`` (H, W, 3). A row block of a larger frame passes
    its first row's global index ``row_offset`` and the frame's height
    (its rows are exact where it reaches ``cfg.window_ky`` rows past
    them). CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    if depth.device.type == "cpu":
        return hbao_fused_plain(depth, normal, cam, frame, cfg, row_offset,
                                frame_height)
    return _launch(depth, normal, cam, frame, cfg, row_offset, frame_height)


def _launch(depth, normal, cam, frame, cfg, row_offset=0, height=None):
    h, w = depth.shape
    hg = h if height is None else int(height)
    if cfg.spp < 1:
        raise ValueError(f"spp must be at least 1, not {cfg.spp}")
    depth = depth.contiguous()
    normal = normal.contiguous()
    fparams = _host_params(cam, cfg, hg, w)
    noise = noise_table(depth.device, fparams[51], fparams[52])
    cuda_build.require_cuda(depth, normal, noise)
    if noise.is_cuda:
        # the cache may drop the table while this stream still reads it
        noise.record_stream(torch.cuda.current_stream(noise.device))
    ao = torch.empty_like(depth)
    carry = (torch.empty((2, h, w), dtype=torch.float32, device=depth.device)
             if cfg.spp > _CHUNK else None)
    shifts = [noise_shift(i, row_offset=row_offset) for i in
              sample_indices(cfg.spp, frame, cfg.animated_noise)]
    ishifts = np.array([s[0] for s in shifts] + [s[1] for s in shifts],
                       np.int32)
    cuda_build.launch("hbao", "hbao", "re_hbao", (5, 7, 2), depth,
                      depth.data_ptr(), normal.data_ptr(), noise.data_ptr(),
                      ao.data_ptr(), None if carry is None else carry.data_ptr(),
                      h, w, int(cfg.window_ky), int(cfg.window_kx), int(cfg.spp),
                      int(row_offset), hg, fparams.ctypes.data, ishifts.ctypes.data)
    return ao
