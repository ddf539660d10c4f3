"""Bounded-window per-pixel warp: the screen-space fetch of the temporal
passes (history Catmull-Rom, disocclusion probe, radiance pre-warp).

Kernel: ``csrc/warp.cu``. It replaces the JAX package's
``ops/pallas/warp.py::_warp_kernel`` (``window_warp``). Semantics, which
the plain version below spells out:

- targets are clipped to +-2^20;
- each filter tap is clamped to the frame (GL clamp-to-edge), then to the
  window: rows within ``+-ky`` widened by the filter reach, columns
  within ``+-(kx + reach)`` (``+-127`` when ``kx`` is None);
- the returned flag marks targets whose displacement is inside
  ``+-ky`` rows and ``+-kx`` columns; callers treat the rest as
  disocclusions;
- ``catrom5`` is the reference's 5-tap Catmull-Rom
  (`reproject.frag:212-255`): the 4x4 footprint with its corner texels
  dropped.

On the H100 the kernel is bound by bytes (targets, fractions and output
a pixel; the texel reads are shared with neighbouring pixels through
L1/L2). One thread per pixel with direct loads: a C = 4 texel is one
16-byte load where the texture is 16-byte aligned (a view at another
offset takes 4-byte loads) and a C = 4 output one 16-byte store; the
filtered modes run 32 x 8 blocks, whose warps share their footprint
rows through L1.

A row block of a larger frame (the split frame's shards) fetches from
its rows extended by ``ky`` plus the filter's reach (``_HALO_EXTRA``) in
halo rows, with its targets re-based by the block's first row, and its
result cropped: the values are those of the whole-frame fetch, as the
window bound is the halo bound and the in-window flag sees only
``ty - row``.

``window_warp_multi`` fetches one texture at N targets, nearest, each
with the semantics above (kernel ``re_warp_multi``, the counterpart of
``ops/pallas/warp.py::_warp_multi_kernel``). The TPU kernel's column
window is exact only for ``kx <= 32`` (a lane split); the port's takes
any ``kx``.
"""

from __future__ import annotations

import torch

from ..core.math3d import floor_int32
from . import cuda_build

DEF_KY = 8
WIDE_KX = 127  # the column window when kx is None
_MODES = {"nearest": 0, "bilinear": 1, "catrom": 2, "catrom5": 3}
_BAND_OFF = {"nearest": (0,), "bilinear": (0, 1), "catrom": (-1, 0, 1, 2),
             "catrom5": (-1, 0, 1, 2)}
_HALO_EXTRA = {"nearest": 0, "bilinear": 1, "catrom": 2, "catrom5": 2}
_C5_OUTER = (0, 3)  # catrom5: bands and taps whose corners carry no weight
_LIM = 1 << 20


def _crw(f):
    """Catmull-Rom weights for fraction f: taps at (-1, 0, +1, +2)."""
    f2 = f * f
    f3 = f2 * f
    w0 = f2 - 0.5 * (f3 + f)
    w1 = 1.5 * f3 - 2.5 * f2 + 1.0
    w3 = 0.5 * (f3 - f2)
    return w0, w1, 1.0 - w0 - w1 - w3, w3


def _windows(mode: str, kx):
    kx_flag = WIDE_KX if kx is None else int(kx)
    kx_tap = WIDE_KX if kx is None else int(kx) + _HALO_EXTRA[mode]
    return kx_flag, kx_tap


def window_warp_plain(tex, ty, tx, fy=None, fx=None, ky=DEF_KY,
                      mode="nearest", kx=None):
    """The kernel's function in PyTorch (gathers). Same arguments and
    results as :func:`window_warp`."""
    base = tex[..., None] if tex.ndim == 2 else tex
    h, w = base.shape[0], base.shape[1]
    kx_flag, kx_tap = _windows(mode, kx)
    ty = torch.clamp(ty, -_LIM, _LIM)
    tx = torch.clamp(tx, -_LIM, _LIM)
    ys = torch.arange(h, dtype=torch.int32, device=tex.device)[:, None]
    xs = torch.arange(w, dtype=torch.int32, device=tex.device)[None, :]
    dy = ty - ys
    dx = tx - xs
    in_window = (dy.abs() <= ky) & (dx.abs() <= kx_flag)
    dyc = torch.clamp(dy, -ky, ky)
    band_off = _BAND_OFF[mode]
    v_lo, v_hi = -ky + min(band_off), ky + max(band_off)

    def row_at(bo):
        r = torch.minimum(torch.maximum(dyc + bo, -ys), (h - 1) - ys)
        return (ys + torch.clamp(r, v_lo, v_hi)).long()

    def col_at(k):
        c = torch.clamp(tx + k, 0, w - 1) - xs
        return (xs + torch.clamp(c, -kx_tap, kx_tap)).long()

    if mode == "nearest":
        wx = wy = (None,)
    elif mode == "bilinear":
        wx = (1.0 - fx, fx)
        wy = (1.0 - fy, fy)
    else:
        wx = _crw(fx)
        wy = _crw(fy)

    out = None
    for b, bo in enumerate(band_off):
        yb = row_at(bo)
        row = None
        for k, ko in enumerate(band_off):
            if mode == "catrom5" and b in _C5_OUTER and k in _C5_OUTER:
                continue
            t = base[yb, col_at(ko)]
            if wx[k] is not None:
                t = t * wx[k][..., None]
            row = t if row is None else row + t
        if wy[b] is not None:
            row = row * wy[b][..., None]
        out = row if out is None else out + row
    if tex.ndim == 2:
        out = out[..., 0]
    return out, in_window


def window_warp(tex: torch.Tensor, ty: torch.Tensor, tx: torch.Tensor,
                fy: torch.Tensor | None = None,
                fx: torch.Tensor | None = None, ky: int = DEF_KY,
                mode: str = "nearest", kx: int | None = None):
    """Fetch ``tex`` (H, W[, C<=8]) float32 at the per-pixel int32 target
    (ty, tx) (+ float32 fractions fy, fx in [0, 1) for the filtered
    modes). Returns (value (H, W[, C]), in_window (H, W) bool). CUDA
    tensors launch the kernel; CPU tensors take the plain version."""
    if mode not in _MODES:
        raise ValueError(f"unknown warp mode {mode!r}")
    if tex.device.type == "cpu":
        return window_warp_plain(tex, ty, tx, fy, fx, ky, mode, kx)
    return _launch(tex, ty, tx, fy, fx, ky, mode, kx)


def _launch(tex, ty, tx, fy, fx, ky, mode, kx):
    base = tex[..., None] if tex.ndim == 2 else tex
    h, w, c = base.shape
    if c > 8:
        raise ValueError(f"window_warp takes at most 8 channels, not {c}")
    if mode == "nearest":
        fy = fx = None
    elif fy is None or fx is None:
        raise ValueError(f"mode {mode!r} needs the fractions fy, fx")
    args = [base.contiguous(), ty.to(torch.int32).contiguous(),
            tx.to(torch.int32).contiguous()]
    args += [] if fy is None else [fy.contiguous(), fx.contiguous()]
    cuda_build.require_cuda(*args)
    out = torch.empty((h, w, c), dtype=torch.float32, device=tex.device)
    flag = torch.empty((h, w), dtype=torch.bool, device=tex.device)
    kx_flag, kx_tap = _windows(mode, kx)
    cuda_build.launch(f"warp_{mode}", "warp", "re_warp", (7, 7), tex,
                      args[0].data_ptr(), args[1].data_ptr(), args[2].data_ptr(),
                      None if fy is None else args[3].data_ptr(),
                      None if fx is None else args[4].data_ptr(),
                      out.data_ptr(), flag.data_ptr(), h, w, c, _MODES[mode],
                      int(ky), kx_flag, kx_tap)
    return (out[..., 0] if tex.ndim == 2 else out), flag


def _split(uv, h, w):
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    return x, y, x0, y0


def _frame_rows(tex, frame_height):
    """The height uv maps onto: the frame's, for a row block of one."""
    return int(tex.shape[0]) if frame_height is None else int(frame_height)


def catmull_rom_window(tex, uv, ky: int = DEF_KY, kx: int | None = None,
                       row_offset: int = 0, frame_height: int | None = None):
    """Catmull-Rom fetch on the true 4x4 footprint at ``uv``.
    Returns (rgba >= 0, in_window flag).

    A row block of a larger frame (``tex`` and ``uv`` both the block's
    rows, halo included) passes its first row's global index
    ``row_offset`` and the frame's height, here and in the fetches
    below: uv maps onto the frame, and the target row is re-based onto
    the block."""
    h, w = _frame_rows(tex, frame_height), tex.shape[1]
    x, y, x0, y0 = _split(uv, h, w)
    val, ok = window_warp(tex, floor_int32(y0) - row_offset, floor_int32(x0),
                          fy=y - y0, fx=x - x0, ky=ky, mode="catrom", kx=kx)
    return torch.clamp(val, min=0.0), ok


def catmull_rom5_window(tex, uv, ky: int = DEF_KY, half: bool = True,
                        kx: int | None = None, row_offset: int = 0,
                        frame_height: int | None = None):
    """The reference's 5-tap Catmull-Rom history fetch at ``uv``
    (`reproject.frag:212-255`): the corner-zeroed 4x4 footprint,
    normalised by the 5-tap weight total, clamped >= 0. ``half=True``
    reads the texture through float16 storage (the rgba16f history
    target, `TemporalReprojectPass.js:141-144`). Returns (rgba, flag)."""
    if half:
        tex = tex.to(torch.float16).to(torch.float32)
    h, w = _frame_rows(tex, frame_height), tex.shape[1]
    x, y, x0, y0 = _split(uv, h, w)
    fx = x - x0
    fy = y - y0
    val, ok = window_warp(tex, floor_int32(y0) - row_offset, floor_int32(x0),
                          fy=fy, fx=fx, ky=ky, mode="catrom5", kx=kx)
    w0x, _, _, w3x = _crw(fx)
    w0y, _, _, w3y = _crw(fy)
    total = 1.0 - (w0x + w3x) * (w0y + w3y)
    if tex.ndim == 3:
        total = total[..., None]
    return torch.clamp(val / total, min=0.0), ok


def bilinear_window(tex, uv, ky: int = DEF_KY, kx: int | None = None,
                    row_offset: int = 0, frame_height: int | None = None):
    """Bilinear fetch at ``uv`` (LinearFilter with clamp-to-edge)."""
    h, w = _frame_rows(tex, frame_height), tex.shape[1]
    x, y, x0, y0 = _split(uv, h, w)
    fx = torch.where(x0 < 0.0, 0.0, x - x0)
    fy = torch.where(y0 < 0.0, 0.0, y - y0)
    return window_warp(tex, floor_int32(y0) - row_offset, floor_int32(x0),
                       fy=fy, fx=fx, ky=ky, mode="bilinear", kx=kx)


def nearest_window(tex, uv, ky: int = DEF_KY, kx: int | None = None,
                   row_offset: int = 0, frame_height: int | None = None):
    """Nearest fetch at ``uv`` (texelFetch)."""
    h, w = _frame_rows(tex, frame_height), tex.shape[1]
    ix = floor_int32(uv[..., 0] * w)
    iy = floor_int32(uv[..., 1] * h)
    return window_warp(tex, iy - row_offset, ix, ky=ky, mode="nearest", kx=kx)


def window_warp_multi_plain(tex, ty, tx, ky=DEF_KY, kx=None):
    """The multi-target kernel's function in PyTorch: the nearest
    :func:`window_warp_plain` of every target at once."""
    return window_warp_plain(tex, ty, tx, ky=ky, mode="nearest", kx=kx)


def window_warp_multi(tex: torch.Tensor, ty: torch.Tensor, tx: torch.Tensor,
                      ky: int = DEF_KY, kx: int | None = None):
    """N nearest window fetches of ``tex`` (H, W[, C<=8]) float32 at the
    int32 targets ``ty``, ``tx`` (N, H, W). Returns (values (N, H, W[, C]),
    in_window (N, H, W) bool). CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    if tex.device.type == "cpu":
        return window_warp_multi_plain(tex, ty, tx, ky, kx)
    return _launch_multi(tex, ty, tx, ky, kx)


def _launch_multi(tex, ty, tx, ky, kx):
    base = tex[..., None] if tex.ndim == 2 else tex
    h, w, c = base.shape
    n = ty.shape[0]
    if c > 8:
        raise ValueError(f"window_warp_multi takes at most 8 channels, not {c}")
    if tuple(ty.shape) != (n, h, w) or tuple(tx.shape) != (n, h, w):
        raise ValueError(f"targets of {tuple(ty.shape)} for a {h}x{w} texture")
    args = [base.contiguous(), ty.to(torch.int32).contiguous(),
            tx.to(torch.int32).contiguous()]
    cuda_build.require_cuda(*args)
    out = torch.empty((n, h, w, c), dtype=torch.float32, device=tex.device)
    flag = torch.empty((n, h, w), dtype=torch.bool, device=tex.device)
    kx_w, _ = _windows("nearest", kx)
    cuda_build.launch("warp_multi", "warp", "re_warp_multi", (5, 6), tex,
                      args[0].data_ptr(), args[1].data_ptr(), args[2].data_ptr(),
                      out.data_ptr(), flag.data_ptr(), h, w, c, n, int(ky), kx_w)
    return (out[..., 0] if tex.ndim == 2 else out), flag


def nearest_window_multi(tex, uvs, ky: int = DEF_KY, kx: int | None = None):
    """N nearest fetches at ``uvs`` (N, H, W, 2) through
    :func:`window_warp_multi`. Returns (values (N, H, W[, C]), in_window
    (N, H, W))."""
    h, w = tex.shape[0], tex.shape[1]
    ix = floor_int32(uvs[..., 0] * w)
    iy = floor_int32(uvs[..., 1] * h)
    return window_warp_multi(tex, iy, ix, ky=ky, kx=kx)
