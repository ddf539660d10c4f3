"""The SSGI sweep march: first hit per ray along its direction bin, with
the prewarped radiance read during the march.

Kernel: ``csrc/sweep.cu``. It replaces the JAX package's
``ops/pallas/sweep.py::_sweep_kernel`` (``sweep_march_vmem``); the plain
version below is the JAX package's jnp executor
(``ops/ssgi_sweep.py:264-313``) written as a per-step gather at each
pixel's own bin, which computes the same values as its whole-frame
rolls. Kernel and plain version agree bit for bit: the same float32
operations in the same order (the kernel is built with ``-fmad=false``).

Inputs (``ops/ssgi_sweep.py`` builds them):

- ``z_tex`` (H, W) float32 view-space z of the depth buffer;
- ``radiance`` (H, W, 4) float16 prewarped radiance + validity, or None;
- ``planes`` (1 + 6 * n_rays, H, W) float32: z0, then per ray
  [k_len, w0^2, w0 * wd, lz, bin, s_end];
- ``table`` (dirs * steps, 3) float32 host array (dy, dx, s) of bin d,
  step k at row d * steps + k, and ``radii_prev`` (steps,) float32.

Per ray it returns (hit bool, s_hit, s_lo, z_d_hit, gi (H, W, 4) float16
or None); a ray that never hits keeps zeros.

The kernel reads the table as :func:`packed_table` lays it out: one
16-byte record a step, rows of an odd stride. A table of any size runs:
in shared memory up to the card's opt-in limit (227 KB on the H100),
from device memory above it. On the H100 the first kernel was held back
by shared-memory bank conflicts on the table, not by bytes; see the
source for the design that removes them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_build

EPS = 1e-6
_PLANES_PER_RAY = 6


def _split_planes(planes, r):
    b = 1 + _PLANES_PER_RAY * r
    return planes[b: b + _PLANES_PER_RAY].unbind(0)


def sweep_march_plain(z_tex, radiance, planes, table, radii_prev, thickness,
                      ray_distance, n_rays: int, dirs: int, steps: int,
                      miss_gi: bool = False):
    """The kernel's function in PyTorch; same arguments and results as
    :func:`sweep_march`."""
    h, w = z_tex.shape
    dev = z_tex.device
    tab = torch.tensor(np.asarray(table, np.float32), device=dev)
    slo = torch.tensor(np.asarray(radii_prev, np.float32), device=dev)
    thickness = float(np.float32(thickness))
    ray_distance = float(np.float32(ray_distance))
    ys = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    z_flat = z_tex.reshape(-1)
    rad_flat = None if radiance is None else radiance.reshape(h * w, 4)
    z0 = planes[0]
    out = []
    for r in range(n_rays):
        k_len, p2, rwd, lz, bin_, s_end = _split_planes(planes, r)
        ok_bin = (bin_ >= 0.0) & (bin_ < float(dirs)) & (bin_ == torch.floor(bin_))
        row0 = torch.where(ok_bin, bin_, 0.0).long() * steps
        hit = torch.zeros((h, w), dtype=torch.bool, device=dev)
        s_hit = torch.zeros((h, w), device=dev)
        s_lo = torch.zeros((h, w), device=dev)
        z_d_hit = torch.zeros((h, w), device=dev)
        gi = (None if rad_flat is None else
              torch.zeros((h, w, 4), dtype=torch.float16, device=dev))
        for k in range(steps):
            row = tab[row0 + k]
            yy = ys + row[..., 0].to(torch.int32)
            xx = xs + row[..., 1].to(torch.int32)
            s = row[..., 2]
            in_frame = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            denom = k_len - s * rwd
            t_s = s * p2 / torch.where(denom.abs() > EPS, denom, EPS)
            valid = ((denom > EPS) & (t_s >= 0.0) & (t_s <= ray_distance)
                     & (s <= s_end))
            q = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
            z_d = z_flat[q]
            diff = z_d - (z0 + t_s * lz)
            live = ok_bin & ~hit & in_frame & valid
            upd = live & (diff >= 0.0) & (diff < thickness)
            hit = hit | upd
            s_hit = torch.where(upd, s, s_hit)
            s_lo = torch.where(upd, slo[k], s_lo)
            z_d_hit = torch.where(upd, z_d, z_d_hit)
            if gi is not None:
                upd_gi = live if miss_gi else upd
                gi = torch.where(upd_gi[..., None], rad_flat[q], gi)
        out.append((hit, s_hit, s_lo, z_d_hit, gi))
    return out


def sweep_march(z_tex, radiance, planes, table, radii_prev, thickness,
                ray_distance, n_rays: int, dirs: int, steps: int,
                miss_gi: bool = False):
    """The march of ``n_rays`` rays (see the module docstring). CUDA
    tensors launch the kernel; CPU tensors take the plain version."""
    if z_tex.device.type == "cpu":
        return sweep_march_plain(z_tex, radiance, planes, table, radii_prev,
                                 thickness, ray_distance, n_rays, dirs,
                                 steps, miss_gi)
    return _launch(z_tex, radiance, planes, table, radii_prev, thickness,
                   ray_distance, n_rays, dirs, steps, miss_gi)


def packed_table(table, radii_prev, dirs: int, steps: int) -> np.ndarray:
    """The (dirs, stride, 4) int32 table the kernel reads: per step
    (dy, dx) truncated to int32 as the plain version does, then the
    float32 bits of s and of radii_prev[k]; ``stride`` is ``steps``
    rounded up to odd, so that rows of different bins start in different
    shared-memory bank groups."""
    tab = np.asarray(table, np.float32).reshape(dirs, steps, 3)
    stride = steps | 1
    out = np.zeros((dirs, stride, 4), np.int32)
    out[:, :steps, 0] = tab[..., 0].astype(np.int32)
    out[:, :steps, 1] = tab[..., 1].astype(np.int32)
    out[:, :steps, 2] = tab[..., 2].view(np.int32)
    out[:, :steps, 3] = np.asarray(radii_prev, np.float32).view(np.int32)[None]
    return out


def host_table(table, radii_prev, dirs: int, steps: int, device) -> torch.Tensor:
    """:func:`packed_table` copied to a CUDA ``device`` without blocking
    the host (through pinned memory)."""
    tab = torch.from_numpy(packed_table(table, radii_prev, dirs, steps))
    if torch.device(device).type != "cuda":
        return tab
    return tab.pin_memory().to(device, non_blocking=True)


def _launch(z_tex, radiance, planes, table, radii_prev, thickness,
            ray_distance, n_rays, dirs, steps, miss_gi):
    h, w = z_tex.shape
    if tuple(planes.shape) != (1 + _PLANES_PER_RAY * n_rays, h, w):
        raise ValueError(f"planes of shape {tuple(planes.shape)} for "
                         f"{n_rays} rays at {(h, w)}")
    if np.asarray(table).shape != (dirs * steps, 3) or \
            np.asarray(radii_prev).shape != (steps,):
        raise ValueError("the step table must be (dirs * steps, 3) and "
                         "radii_prev (steps,)")
    tensors = [z_tex.contiguous(), planes.contiguous()]
    if radiance is not None:
        if tuple(radiance.shape) != (h, w, 4) or radiance.dtype != torch.float16:
            raise ValueError("radiance must be (H, W, 4) float16")
        tensors.append(radiance.contiguous())
    cuda_build.require_cuda(*tensors)
    dev = z_tex.device
    tab = host_table(table, radii_prev, dirs, steps, dev)
    hit = torch.empty((n_rays, h, w), dtype=torch.bool, device=dev)
    fout = torch.empty((n_rays, 3, h, w), dtype=torch.float32, device=dev)
    gi = (None if radiance is None else
          torch.empty((n_rays, h, w, 4), dtype=torch.float16, device=dev))
    fparams = np.array([thickness, ray_distance], np.float32)
    # counted by rays: "sweep" SSGI's two, "sweep_1ray" SSR's one
    key = "sweep" if n_rays == 2 else f"sweep_{n_rays}ray"
    cuda_build.launch(key, "sweep", "re_sweep", (7, 7, 1), z_tex,
                      tensors[0].data_ptr(), None if gi is None else tensors[2].data_ptr(),
                      tensors[1].data_ptr(), tab.data_ptr(), hit.data_ptr(),
                      fout.data_ptr(), None if gi is None else gi.data_ptr(), h, w,
                      n_rays, dirs, steps, tab.shape[1], int(miss_gi),
                      fparams.ctypes.data)
    return [(hit[r], fout[r, 0], fout[r, 1], fout[r, 2],
             None if gi is None else gi[r]) for r in range(n_rays)]
