"""Z-buffer visibility: the raster's z-scan over a per-triangle table.

Kernel: ``csrc/raster.cu``. It replaces the JAX package's
``ops/pallas/raster.py::_zscan_kernel`` (``zscan_visibility``), whose
semantics are ``scene/rasterizer._visibility``'s scan step: the same
covered tests and guards, and strict ``z < zbuf``, so the first triangle
wins a tie. As in the TPU kernel the linear interpolants (sum e_i w_i,
sum e_i z_i, sum e_i) are hoisted into per-triangle plane coefficients
(:func:`zscan_table`); that is exact algebra, and the float32 rounding
differs from the scan's per-pixel sums in the last ulp, so a winner can
flip only where two triangles tie within about an ulp of z.

The TPU kernel's batching of scenes above 4096 triangles (an SMEM limit)
is not semantics and is not ported: one pass in triangle order with the
strict test gives the same winners. Kernel and plain version agree bit
for bit (same operations in the same order; built with ``-fmad=false``).
On the H100 a kernel in which every thread tests every triangle's bbox
is bound by instruction issue, not by the output write that bounds the
z-scan; the kernel bins triangles per 16 x 32 tile in triangle order
and each thread walks only its tile's list. See the source.
"""

from __future__ import annotations

import torch

from ..core.math3d import fma
from . import cuda_build

NQ = 24  # floats per triangle row (23 used)


def _dot3(c, a):
    """sum_i c[:, i, :] * a[:, i, None]: (F, 3), as the JAX package's
    einsum computes it on the CPU (an FMA chain in index order)."""
    acc = c[:, 0] * a[:, 0, None]
    acc = fma(c[:, 1], a[:, 1, None], acc)
    return fma(c[:, 2], a[:, 2, None], acc)


def zscan_table(coeffs, tri_z, tri_w, sgn, valid, tri_bbox) -> torch.Tensor:
    """The kernel's (F, 24) float32 triangle table from ``_visibility``'s
    per-triangle arrays: ``coeffs`` (F, 3, 3) scaled edge coefficients,
    ``tri_z`` / ``tri_w`` (F, 3) scaled clip z and w per vertex, ``sgn``
    (F,) winding sign, ``valid`` (F,) bool, ``tri_bbox`` (F, 4) xmin,
    xmax, ymin, ymax. ``valid`` folds into an empty bbox."""
    f = coeffs.shape[0]
    inf = float("inf")
    zw3 = _dot3(coeffs, tri_w)
    zc3 = _dot3(coeffs, tri_z)
    se3 = coeffs[:, 0] + coeffs[:, 1] + coeffs[:, 2]
    ymin = torch.where(valid, tri_bbox[:, 2], inf)
    ymax = torch.where(valid, tri_bbox[:, 3], -inf)
    xmin = torch.where(valid, tri_bbox[:, 0], inf)
    xmax = torch.where(valid, tri_bbox[:, 1], -inf)
    return torch.cat([
        coeffs.reshape(f, 9), zw3, zc3, se3, sgn[:, None],
        torch.stack([ymin, ymax, xmin, xmax], -1),
        torch.zeros((f, NQ - 23), dtype=coeffs.dtype, device=coeffs.device),
    ], -1).float().contiguous()


def zscan_plain(tab: torch.Tensor, height: int, width: int):
    """The kernel's function in PyTorch: triangles in chunks against
    every pixel, the first minimum of a chunk against the carried z with
    strict <. Returns (ids (H, W) int32, z_ndc (H, W) float32, +inf where
    no triangle covers the pixel)."""
    dev = tab.device
    n = tab.shape[0]
    px = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)[None, :, None]
    py = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5)[:, None, None]
    zbuf = torch.full((height, width), float("inf"), device=dev)
    ids = torch.full((height, width), -1, dtype=torch.int32, device=dev)
    chunk = max(1, min(n, (1 << 24) // (height * width)))
    plane = lambda q, i: q[:, i] * px + q[:, i + 1] * py + q[:, i + 2]
    for base in range(0, n, chunk):
        q = tab[base: base + chunk]
        s = q[:, 18]
        e0, e1, e2 = plane(q, 0), plane(q, 3), plane(q, 6)
        covered = (e0 * s >= 0.0) & (e1 * s >= 0.0) & (e2 * s >= 0.0)
        covered &= ((px >= q[:, 21]) & (px <= q[:, 22])
                    & (py >= q[:, 19]) & (py <= q[:, 20]))
        zw, zc, se = plane(q, 9), plane(q, 12), plane(q, 15)
        se_safe = torch.where(se.abs() > 1e-20, se, 1e-20)
        covered &= zw / se_safe > 1e-6
        z_ndc = zc / torch.where(zw.abs() > 1e-20, zw, 1e-20)
        covered &= (z_ndc >= -1.0) & (z_ndc <= 1.0)
        z_best, k_best = torch.where(covered, z_ndc, float("inf")).min(-1)
        better = z_best < zbuf
        zbuf = torch.where(better, z_best, zbuf)
        ids = torch.where(better, (k_best + base).to(torch.int32), ids)
    return ids, zbuf


def zscan(tab: torch.Tensor, height: int, width: int):
    """(ids, z_ndc) of the table ``tab`` (F, 24) at (height, width); see
    :func:`zscan_plain`. CUDA tensors launch the kernel; CPU tensors take
    the plain version."""
    if tab.device.type == "cpu":
        return zscan_plain(tab, height, width)
    out = _launch(tab, height, width)
    zscan.launches += 1
    return out


zscan.launches = 0


def zscan_visibility(coeffs, tri_z, tri_w, sgn, valid, tri_bbox,
                     height: int, width: int):
    """The z-scan of ``_visibility``'s per-triangle arrays (see
    :func:`zscan_table`): (ids (H, W) int32 winner, -1 for none; z_ndc
    (H, W) float32 winner depth, +inf for none)."""
    return zscan(zscan_table(coeffs, tri_z, tri_w, sgn, valid, tri_bbox),
                 height, width)


def _launch(tab, height, width):
    if tab.ndim != 2 or tab.shape[1] != NQ or tab.dtype != torch.float32:
        raise ValueError(f"the z-scan table must be (F, {NQ}) float32, not "
                         f"{tuple(tab.shape)} {tab.dtype}")
    tab = tab.contiguous()
    cuda_build.require_cuda(tab)
    z = torch.empty((height, width), dtype=torch.float32, device=tab.device)
    ids = torch.empty((height, width), dtype=torch.int32, device=tab.device)
    fn = cuda_build.bind("raster", "re_zscan", 3, 3)
    err = fn(tab.data_ptr(), z.data_ptr(), ids.data_ptr(), tab.shape[0],
             height, width, cuda_build.stream_ptr(tab))
    cuda_build.check(err, "z-scan kernel")
    return ids, z
