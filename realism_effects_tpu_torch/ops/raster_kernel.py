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

The alpha variant (:func:`zscan_alpha_peels`, ``re_zscan_peels``) runs
every depth-peel pass of ``_visibility``'s stochastic-alpha scan, which
the JAX package runs as an XLA scan (``scene/rasterizer.py:232-295``)
and a peel loop (``:334-345``), not through its Pallas kernel: the
material-alpha law (a hard 0.5 cut on the first still frame, a dither
against the convergence law's soft alpha later) and, in pass p, the
exclusion of the earlier passes' winners by id. Pass p's winner is the
(p+1)-th smallest (z, id) of the triangles that pass, so one launch
keeps each pixel's P smallest and returns the P planes; its plain twin
is P passes of :func:`zscan_plain` with the exclusion stack. The law's
two sums ``cnmf * 0.1 + 1`` and ``a + (a_step - a) * ramp`` are fused
multiply-adds, as XLA's CPU backend contracts them in the scan's body.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.math3d import fma
from . import cuda_build

NQ = 24  # floats per triangle row (23 used)
#: the plain version's tile (pixels a side): it evaluates only the
#: triangles whose bbox reaches a tile, which changes no result
PLAIN_TILE = 128


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


def soft_alpha(alpha: torch.Tensor, cnmf: float):
    """(keep_all bool, a_soft float32, hard) of the convergence law
    (`GBufferMaterial.js:63-79`) for alpha ``alpha`` (any shape) at
    ``cnmf`` still frames: an alpha passes where keep_all, else where
    dither < a_soft, unless ``hard`` (the first still frame, cnmf < 0.5).
    ``ramp = 1 / fma(cnmf, 0.1, 1)`` and ``a_soft = fma(a_step - a, ramp,
    a)``, the fused form XLA's CPU backend compiles the law to."""
    c = np.float32(cnmf)
    ramp = np.float32(1.0) / np.float32(np.float64(c) * np.float64(np.float32(0.1)) + 1.0)
    a_step = (alpha >= 0.5).float()
    a_soft = fma(a_step - alpha, torch.full_like(alpha, float(ramp)), alpha)
    hard = bool(c < 0.5)
    return (alpha >= 0.5) if hard else (alpha >= 0.9999), a_soft, hard


def zscan_plain(tab: torch.Tensor, height: int, width: int,
                alpha: torch.Tensor | None = None,
                dither: torch.Tensor | None = None, cnmf: float = 0.0,
                exclude: torch.Tensor | None = None):
    """The kernel's function in PyTorch: per tile of ``PLAIN_TILE``
    pixels, the triangles whose bbox reaches the tile (the others cover
    none of its pixels), in id order and in chunks against each pixel of
    the tile, the first minimum of a chunk against the carried z with
    strict <. Returns (ids (H, W) int32, z_ndc (H, W) float32, +inf where
    no triangle covers the pixel). With ``alpha`` (F,) the alpha
    variant's: the material-alpha law against ``dither`` (H, W) at
    ``cnmf`` still frames, and no triangle wins a pixel it won in a pass
    of ``exclude`` (P, H, W) int32. The tiles' triangle lists are built
    together, so a call reads back from the device twice, not once a
    tile."""
    dev = tab.device
    zbuf = torch.full((height, width), float("inf"), device=dev)
    ids = torch.full((height, width), -1, dtype=torch.int32, device=dev)
    if alpha is not None:
        keep_all, a_soft, hard = soft_alpha(alpha, cnmf)
    t = PLAIN_TILE
    y0s, x0s = range(0, height, t), range(0, width, t)
    ty0 = torch.tensor(y0s, dtype=torch.float32, device=dev)[:, None, None]
    tx0 = torch.tensor(x0s, dtype=torch.float32, device=dev)[None, :, None]
    ty1, tx1 = torch.clamp(ty0 + t, max=height), torch.clamp(tx0 + t, max=width)
    reach = ((tab[:, 19] <= ty1 - 0.5) & (tab[:, 20] >= ty0 + 0.5)
             & (tab[:, 21] <= tx1 - 0.5) & (tab[:, 22] >= tx0 + 0.5))
    counts = reach.sum(-1).flatten().tolist()
    lists = iter(reach.flatten(0, 1).nonzero()[:, 1].split(counts))
    for y0 in y0s:
        for x0 in x0s:
            y1, x1 = min(y0 + t, height), min(x0 + t, width)
            sel = next(lists)
            if sel.numel() == 0:
                continue
            px = (torch.arange(x0, x1, dtype=torch.float32, device=dev) + 0.5)[None, :, None]
            py = (torch.arange(y0, y1, dtype=torch.float32, device=dev) + 0.5)[:, None, None]
            zt, it = zbuf[y0:y1, x0:x1], ids[y0:y1, x0:x1]
            chunk = max(1, (1 << 24) // ((y1 - y0) * (x1 - x0)))
            plane = lambda q, i: q[:, i] * px + q[:, i + 1] * py + q[:, i + 2]
            for base in range(0, sel.numel(), chunk):
                tid = sel[base: base + chunk]
                q = tab[tid]
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
                if alpha is not None:
                    passes = keep_all[tid]
                    if not hard:
                        passes = passes | (dither[y0:y1, x0:x1, None] < a_soft[tid])
                    covered &= passes
                    if exclude is not None:
                        for prev in exclude:
                            covered &= tid.to(torch.int32) != prev[y0:y1, x0:x1, None]
                z_best, k_best = torch.where(covered, z_ndc, float("inf")).min(-1)
                better = z_best < zt
                zt = torch.where(better, z_best, zt)
                it = torch.where(better, tid[k_best].to(torch.int32), it)
            zbuf[y0:y1, x0:x1] = zt
            ids[y0:y1, x0:x1] = it
    return ids, zbuf


def zscan(tab: torch.Tensor, height: int, width: int):
    """(ids, z_ndc) of the table ``tab`` (F, 24) at (height, width); see
    :func:`zscan_plain`. CUDA tensors launch the kernel; CPU tensors take
    the plain version."""
    if tab.device.type == "cpu":
        return zscan_plain(tab, height, width)
    return _launch(tab, height, width)


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
    cuda_build.launch("zscan", "raster", "re_zscan", (3, 3), tab,
                      tab.data_ptr(), z.data_ptr(), ids.data_ptr(), tab.shape[0],
                      height, width)
    return ids, z


def zscan_alpha_peels_plain(tab: torch.Tensor, height: int, width: int,
                            alpha: torch.Tensor, dither: torch.Tensor,
                            cnmf: float, passes: int):
    """The alpha variant's function in PyTorch: ``passes`` passes of
    :func:`zscan_plain`, pass p excluding the winners of passes 0 .. p-1.
    Returns (ids (P, H, W) int32, z_ndc (P, H, W) float32)."""
    ids = torch.empty((passes, height, width), dtype=torch.int32, device=tab.device)
    z = torch.empty((passes, height, width), dtype=torch.float32, device=tab.device)
    for p in range(passes):
        ids[p], z[p] = zscan_plain(tab, height, width, alpha, dither, cnmf,
                                   ids[:p] if p else None)
    return ids, z


def zscan_alpha_peels(tab: torch.Tensor, height: int, width: int,
                      alpha: torch.Tensor, dither: torch.Tensor, cnmf: float,
                      passes: int):
    """(ids, z_ndc), each (P, H, W), of the ``passes`` depth-peel passes
    of the stochastic-alpha scan (see :func:`zscan_alpha_peels_plain`):
    ``alpha`` (F,) material alpha, ``dither`` (H, W), ``cnmf`` the
    camera's still-frame count; plane p is pass p's winner (-1 and +inf
    for none). CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    if tab.device.type == "cpu":
        return zscan_alpha_peels_plain(tab, height, width, alpha, dither, cnmf, passes)
    return _launch_peels(tab, height, width, alpha, dither, cnmf, passes)


def _launch_peels(tab, height, width, alpha, dither, cnmf, passes):
    if tab.ndim != 2 or tab.shape[1] != NQ or tab.dtype != torch.float32:
        raise ValueError(f"the z-scan table must be (F, {NQ}) float32, not "
                         f"{tuple(tab.shape)} {tab.dtype}")
    if alpha.shape != (tab.shape[0],) or tuple(dither.shape) != (height, width):
        raise ValueError("alpha (F,) and dither (H, W) must match the table "
                         "and the frame")
    if passes < 1:
        raise ValueError(f"the alpha z-scan takes at least one pass, not {passes}")
    tab, alpha, dither = tab.contiguous(), alpha.float().contiguous(), dither.float()
    cuda_build.require_cuda(tab, alpha)
    # the dither is read through its strides (the composer's is a channel
    # of the tiled blue noise: a view, which a copy would cost a pass over)
    if dither.device != tab.device:
        raise ValueError(f"the dither is on {dither.device}, the table on {tab.device}")
    prep = torch.empty((tab.shape[0], 8), dtype=torch.float32, device=tab.device)
    z = torch.empty((passes, height, width), dtype=torch.float32, device=tab.device)
    ids = torch.empty((passes, height, width), dtype=torch.int32, device=tab.device)
    host = np.array([cnmf], np.float32)
    cuda_build.launch("zscan_peels", "raster", "re_zscan_peels", (6, 6, 1), tab,
                      tab.data_ptr(), alpha.data_ptr(), dither.data_ptr(),
                      prep.data_ptr(), z.data_ptr(), ids.data_ptr(), tab.shape[0],
                      height, width, dither.stride(0), dither.stride(1), passes,
                      host.ctypes.data)
    return ids, z
