"""Clamp-to-edge texture fetches over ``(H, W[, C])`` tensors, with the
uv conventions of the JAX package's ``core/sampling.py``.

- :func:`sample_nearest`  -- ``texelFetch`` / NearestFilter
- :func:`sample_bilinear` -- ``textureLod(tex, uv, 0.)`` with LinearFilter
  (a float16 texture is read as an rgba16f target)
- :func:`sample_catmull_rom_5tap` -- the temporal history filter
  (`reproject.frag:212-255`) as five bilinear taps
- :func:`sample_bilinear_mip` -- trilinear fetch from an explicit mip
  chain (the GGX prefilter's reads)
- :func:`sample_mip_atlas` -- ``textureLod`` with a per-pixel lod from a
  :class:`MipAtlas` (the environment's mips, `ssgi_utils.frag:90-92`)
"""

from __future__ import annotations

import dataclasses

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
    if half or base.dtype == torch.float16:
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


def sample_catmull_rom_5tap(tex: torch.Tensor, uv: torch.Tensor,
                            half: bool = False) -> torch.Tensor:
    """5-tap bicubic Catmull-Rom (`reproject.frag:212-255`), clamped at
    >= 0; ``half`` reads the texture as an rgba16f target. The window
    warp's catrom5 mode (``ops/warp.py``) computes the same filter inside
    its window; this is the unbounded form."""
    h, w = tex.shape[0], tex.shape[1]
    size = torch.tensor([float(w), float(h)], device=uv.device)
    inv_size = 1.0 / size
    pix = uv * size
    tc = torch.floor(pix - 0.5) + 0.5
    f = pix - tc
    f2 = f * f
    f3 = f2 * f
    w0 = f2 - 0.5 * (f3 + f)
    w1 = 1.5 * f3 - 2.5 * f2 + 1.0
    w3 = 0.5 * (f3 - f2)
    w2 = 1.0 - w0 - w1 - w3
    weight1 = w1 + w2
    sample0 = (tc - 1.0) * inv_size
    sample1 = (tc + w2 / weight1) * inv_size
    sample2 = (tc + 2.0) * inv_size
    sw0 = weight1[..., 0] * w0[..., 1]
    sw1 = w0[..., 0] * weight1[..., 1]
    sw2 = weight1[..., 0] * weight1[..., 1]
    sw3 = w3[..., 0] * weight1[..., 1]
    sw4 = weight1[..., 0] * w3[..., 1]

    def tap(ux, uy):
        return sample_bilinear(tex, torch.stack([ux, uy], dim=-1), half=half)

    expand = (lambda a: a[..., None]) if tex.ndim == 3 else (lambda a: a)
    acc = tap(sample1[..., 0], sample0[..., 1]) * expand(sw0)
    acc = acc + tap(sample0[..., 0], sample1[..., 1]) * expand(sw1)
    acc = acc + tap(sample1[..., 0], sample1[..., 1]) * expand(sw2)
    acc = acc + tap(sample2[..., 0], sample1[..., 1]) * expand(sw3)
    acc = acc + tap(sample1[..., 0], sample2[..., 1]) * expand(sw4)
    total = sw0 + sw1 + sw2 + sw3 + sw4
    return torch.clamp(acc * expand(1.0 / total), min=0.0)


def sample_bilinear_mip(mips, uv: torch.Tensor, lod) -> torch.Tensor:
    """Trilinear fetch from an explicit mip chain at the fractional
    ``lod`` (a float or a tensor broadcastable to ``uv[..., 0]``): every
    level is fetched and blended by its weight, 0 for all but two."""
    n = len(mips)
    lod = torch.clamp(torch.as_tensor(lod, dtype=torch.float32, device=uv.device),
                      0.0, n - 1)
    lod0 = torch.floor(lod)
    frac = lod - lod0
    expand = (lambda a: a[..., None]) if mips[0].ndim == 3 else (lambda a: a)
    out = None
    for i, mip in enumerate(mips):
        wgt = torch.where(lod0 == i, 1.0 - frac,
                          torch.where(lod0 == i - 1, frac, 0.0))
        contrib = sample_bilinear(mip, uv) * expand(wgt)
        out = contrib if out is None else out + contrib
    return out


def build_mip_chain(tex: torch.Tensor, max_levels: int | None = None):
    """Successive 2x2 box-filter downsamples (GL mipmap generation)."""
    mips = [tex]
    h, w = tex.shape[0], tex.shape[1]
    while h > 1 and w > 1 and (max_levels is None or len(mips) < max_levels):
        h2, w2 = h // 2, w // 2
        cur = mips[-1][: h2 * 2, : w2 * 2]
        mips.append(cur.reshape(h2, 2, w2, 2, *tex.shape[2:]).mean(dim=(1, 3)))
        h, w = h2, w2
    return mips


@dataclasses.dataclass(frozen=True)
class MipAtlas:
    """All mip levels of an image stacked vertically in one (H', W', C)
    strip, each level padded by one edge-replicated row and column (so a
    bilinear tap at a level's last row or column stays inside the
    level); ``shapes`` holds (row_offset, h, w) per level."""

    data: torch.Tensor
    shapes: tuple

    @property
    def levels(self) -> int:
        return len(self.shapes)


def build_mip_atlas(tex: torch.Tensor) -> MipAtlas:
    """The strip of an (H, W, C) image's mip chain."""
    c = tex.shape[2] if tex.ndim == 3 else 1
    strip_w = tex.shape[1] + 1
    rows, shapes, off = [], [], 0
    for m in build_mip_chain(tex):
        m3 = m if m.ndim == 3 else m[..., None]
        h, w = m3.shape[0], m3.shape[1]
        m3 = torch.cat([m3, m3[:, -1:]], dim=1)
        m3 = torch.cat([m3, m3[-1:]], dim=0)
        if m3.shape[1] < strip_w:
            m3 = torch.cat([m3, m3.new_zeros(m3.shape[0], strip_w - m3.shape[1], c)],
                           dim=1)
        rows.append(m3)
        shapes.append((off, h, w))
        off += h + 1
    return MipAtlas(torch.cat(rows, dim=0), tuple(shapes))


def _atlas_bilinear(atlas: MipAtlas, uv: torch.Tensor, lvl: torch.Tensor):
    """Bilinear fetch at the integer level ``lvl`` (float, per pixel):
    x0/y0 clamped to the level, so the +1 corners land in its
    edge-replicated pad (per-level clamp-to-edge)."""
    offset = torch.zeros_like(lvl)
    h_l = torch.ones_like(lvl)
    w_l = torch.ones_like(lvl)
    for k, (off, h, w) in enumerate(atlas.shapes):
        is_k = lvl == float(k)
        offset = torch.where(is_k, float(off), offset)
        h_l = torch.where(is_k, float(h), h_l)
        w_l = torch.where(is_k, float(w), w_l)
    x = uv[..., 0] * w_l - 0.5
    y = uv[..., 1] * h_l - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = torch.where(x0 < 0.0, 0.0, x - x0)[..., None]
    fy = torch.where(y0 < 0.0, 0.0, y - y0)[..., None]
    x0 = torch.minimum(torch.clamp(x0, min=0.0), w_l - 1.0)
    y0 = torch.minimum(torch.clamp(y0, min=0.0), h_l - 1.0)
    iy = floor_int32(offset + y0)
    ix = floor_int32(x0)
    data = atlas.data
    c00 = _gather2d(data, iy, ix).float()
    c01 = _gather2d(data, iy, ix + 1).float()
    c10 = _gather2d(data, iy + 1, ix).float()
    c11 = _gather2d(data, iy + 1, ix + 1).float()
    top = c00 + (c01 - c00) * fx
    bot = c10 + (c11 - c10) * fx
    return top + (bot - top) * fy


def sample_mip_atlas(atlas: MipAtlas, uv: torch.Tensor, lod,
                     quantize: bool = False) -> torch.Tensor:
    """Trilinear fetch at the per-pixel fractional ``lod``; an integral
    float ``lod`` reads one level, ``quantize=True`` rounds the lod to
    the nearest level (one bilinear tap instead of two)."""
    if isinstance(lod, (int, float)) and float(lod) == int(lod):
        lvl = min(max(int(lod), 0), atlas.levels - 1)
        return _atlas_bilinear(atlas, uv, torch.full_like(uv[..., 0], float(lvl)))
    lod = torch.as_tensor(lod, dtype=torch.float32, device=uv.device)
    lod = torch.clamp(lod.expand(uv.shape[:-1]), 0.0, atlas.levels - 1)
    if quantize:
        return _atlas_bilinear(atlas, uv, torch.round(lod))
    l0 = torch.floor(lod)
    frac = (lod - l0)[..., None]
    a = _atlas_bilinear(atlas, uv, l0)
    b = _atlas_bilinear(atlas, uv, torch.clamp(l0 + 1.0, max=atlas.levels - 1.0))
    return a + (b - a) * frac
