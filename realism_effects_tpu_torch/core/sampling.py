"""Clamp-to-edge texture fetches over ``(H, W[, C])`` tensors, with the
uv conventions of the JAX package's ``core/sampling.py``.

- :func:`sample_nearest`  -- ``texelFetch`` / NearestFilter
- :func:`sample_bilinear` -- ``textureLod(tex, uv, 0.)`` with LinearFilter
"""

from __future__ import annotations

import torch

from .math3d import floor_int32


def _gather2d(tex: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor):
    h, w = tex.shape[0], tex.shape[1]
    iy = torch.clamp(iy, 0, h - 1).long()
    ix = torch.clamp(ix, 0, w - 1).long()
    return tex[iy, ix]


def sample_nearest(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbor fetch. uv (..., 2) -> (..., C) (or scalar maps)."""
    h, w = tex.shape[0], tex.shape[1]
    ix = floor_int32(uv[..., 0] * w)
    iy = floor_int32(uv[..., 1] * h)
    return _gather2d(tex, iy, ix)


def sample_bilinear(tex: torch.Tensor, uv: torch.Tensor,
                    half: bool = False) -> torch.Tensor:
    """Bilinear fetch with clamp-to-edge (GL LinearFilter): four clamped
    corner fetches. Where ``floor`` lands at -1 the lerp fraction is
    zeroed, the value the clamped corners give. ``half=True`` reads the
    texture through float16 storage (an rgba16f render target)."""
    h, w = tex.shape[0], tex.shape[1]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = torch.where(x0 < 0.0, 0.0, x - x0)
    fy = torch.where(y0 < 0.0, 0.0, y - y0)
    x0 = floor_int32(x0)
    y0 = floor_int32(y0)
    base = tex[..., None] if tex.ndim == 2 else tex
    if half:
        base = base.to(torch.float16).to(torch.float32)
    c00 = _gather2d(base, y0, x0)
    c01 = _gather2d(base, y0, x0 + 1)
    c10 = _gather2d(base, y0 + 1, x0)
    c11 = _gather2d(base, y0 + 1, x0 + 1)
    fx = fx[..., None]
    fy = fy[..., None]
    top = c00 + (c01 - c00) * fx
    bot = c10 + (c11 - c10) * fx
    out = top + (bot - top) * fy
    return out[..., 0] if tex.ndim == 2 else out
