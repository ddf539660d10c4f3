"""Equirectangular environment maps: sampling, mips and the importance-
sampling CDF tables (the JAX package's ``core/envmap.py``).

- direction <-> equirect uv (`ssgi_utils.frag:64-92`);
- the luminance inverse-CDF tables the reference builds in a Web Worker
  (`EquirectHdrInfoUniform.js:149-245`): built on the host, by the C++
  library in ``native/`` or by numpy, then copied to the device once;
- the mip atlas for blurred fetches (``envBlur``, `ssgi.frag:322-327`).

Cube maps, the GGX prefilter and ``blur_env`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .math3d import luminance
from .sampling import (MipAtlas, build_mip_atlas, build_mip_chain,
                       sample_bilinear, sample_mip_atlas)


@dataclasses.dataclass(frozen=True)
class EquirectEnv:
    """The device-side environment: ``mips`` (H, W, 3) float16 levels,
    the same pyramid as one float16 :class:`MipAtlas`, the inverse-CDF
    lookups ``marginal`` (H,) and ``conditional`` (H, W), the luminance
    sum ``total_sum`` (a 0-d tensor) and ``cdf_packed``, the (Hc, Wc, 4)
    float16 table [u, v, lum, 0] that composes the marginal ->
    conditional -> colour chain into one fetch."""

    mips: tuple
    atlas: MipAtlas
    marginal: torch.Tensor
    conditional: torch.Tensor
    total_sum: torch.Tensor
    cdf_packed: torch.Tensor | None = None

    @property
    def map(self) -> torch.Tensor:
        return self.mips[0]

    @property
    def size(self) -> tuple:
        return self.mips[0].shape[0], self.mips[0].shape[1]

    @property
    def max_mip_level(self) -> int:
        return len(self.mips) - 1

    @property
    def device(self) -> torch.device:
        return self.marginal.device


def direction_to_equirect_uv(direction: torch.Tensor) -> torch.Tensor:
    """(..., 3) world direction -> equirect uv (`ssgi_utils.frag:64-74`)."""
    u = torch.atan2(direction[..., 2], direction[..., 0]) / (2.0 * math.pi) + 0.5
    v = 1.0 - torch.acos(torch.clamp(direction[..., 1], -1.0, 1.0)) / math.pi
    return torch.stack([u, v], dim=-1)


def equirect_uv_to_direction(uv: torch.Tensor) -> torch.Tensor:
    """Equirect uv -> (..., 3) world direction (`ssgi_utils.frag:77-86`)."""
    theta = (uv[..., 0] - 0.5) * 2.0 * math.pi
    phi = (1.0 - uv[..., 1]) * math.pi
    sin_phi = torch.sin(phi)
    return torch.stack([sin_phi * torch.cos(theta), torch.cos(phi),
                        sin_phi * torch.sin(theta)], dim=-1)


def sample_equirect_color(env: EquirectEnv, direction: torch.Tensor, lod,
                          quantize: bool = False) -> torch.Tensor:
    """``sampleEquirectEnvMapColor`` (`ssgi_utils.frag:90-92`) from the
    mip atlas; ``quantize`` rounds the lod to the nearest level."""
    uv = direction_to_equirect_uv(direction)
    return sample_mip_atlas(env.atlas, uv, lod, quantize=quantize)


def sample_equirect_probability(env: EquirectEnv, noise2: torch.Tensor,
                                fast: bool = False):
    """Importance-sample the environment (`ssgi_utils.frag:210-225`).
    ``noise2``: (..., 2) uniforms. Returns (pdf, direction), pdf =
    ``width * height * lum / totalSum``. ``fast`` reads the composed
    ``cdf_packed`` table (one fetch, bilinear in the noise) instead of the
    exact marginal -> conditional -> colour chain."""
    h, w = env.size
    if fast and env.cdf_packed is not None:
        t = sample_bilinear(env.cdf_packed,
                            torch.stack([noise2[..., 1], noise2[..., 0]], -1))
        direction = equirect_uv_to_direction(t[..., 0:2])
        pdf = t[..., 2] / env.total_sum
        return (w * h) * pdf, direction
    zero = torch.zeros_like(noise2[..., 0])
    v = sample_bilinear(env.marginal[:, None],
                        torch.stack([zero, noise2[..., 0]], -1))
    u = sample_bilinear(env.conditional, torch.stack([noise2[..., 1], v], -1))
    uv = torch.stack([u, v], dim=-1)
    direction = equirect_uv_to_direction(uv)
    pdf = luminance(sample_bilinear(env.map, uv)) / env.total_sum
    return (w * h) * pdf, direction


# ---------------------------------------------------------------------------
# host-side construction (the reference's Web Worker)
# ---------------------------------------------------------------------------

def _np_bilinear(tex: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Host bilinear with :func:`sample_bilinear`'s clamp-to-edge (x, y
    in texel units, already -0.5)."""
    h, w = tex.shape[:2]
    x0 = np.floor(x)
    y0 = np.floor(y)
    fx = np.where(x0 < 0.0, 0.0, x - x0)
    fy = np.where(y0 < 0.0, 0.0, y - y0)
    xi = np.clip(x0.astype(np.int64), 0, w - 1)
    yi = np.clip(y0.astype(np.int64), 0, h - 1)
    xj = np.clip(xi + 1, 0, w - 1)
    yj = np.clip(yi + 1, 0, h - 1)
    if tex.ndim == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    top = tex[yi, xi] + (tex[yi, xj] - tex[yi, xi]) * fx
    bot = tex[yj, xi] + (tex[yj, xj] - tex[yj, xi]) * fx
    return top + (bot - top) * fy


def _build_cdf_packed(data: np.ndarray, marginal: np.ndarray,
                      conditional: np.ndarray) -> np.ndarray:
    """The inverse-CDF chain evaluated in float64 on a dense noise grid
    (rows: noise.x, the marginal lookup; columns: noise.y, the
    conditional one), [u, v, lum, 0] per cell, stored as float16."""
    h, w = conditional.shape
    hc = int(min(max(4 * h, 64), 1024))
    wc = int(min(max(2 * w, 64), 1024))
    nx = (np.arange(hc, dtype=np.float64) + 0.5) / hc
    ny = (np.arange(wc, dtype=np.float64) + 0.5) / wc
    ym = nx * h - 0.5
    y0m = np.floor(ym)
    fym = np.where(y0m < 0.0, 0.0, ym - y0m)
    yim = np.clip(y0m.astype(np.int64), 0, h - 1)
    yjm = np.clip(yim + 1, 0, h - 1)
    marg = marginal.astype(np.float64)
    v = marg[yim] + (marg[yjm] - marg[yim]) * fym
    vy = np.broadcast_to(v[:, None], (hc, wc)) * h - 0.5
    uxx = np.broadcast_to(ny[None, :], (hc, wc)) * w - 0.5
    u = _np_bilinear(conditional.astype(np.float64), uxx, vy)
    col = _np_bilinear(data.astype(np.float64), u * w - 0.5,
                       np.broadcast_to(v[:, None], (hc, wc)) * h - 0.5)
    lum = 0.2125 * col[..., 0] + 0.7154 * col[..., 1] + 0.0721 * col[..., 2]
    packed = np.stack([u, np.broadcast_to(v[:, None], (hc, wc)), lum,
                       np.zeros_like(u)], axis=-1)
    return packed.astype(np.float16)


def _cdf_numpy(data: np.ndarray):
    """Marginal and conditional inverse CDFs and the luminance total
    (`EquirectHdrInfoUniform.js:149-245`, half-texel centred)."""
    h, w = data.shape[:2]
    lum = (0.2125 * data[..., 0] + 0.7154 * data[..., 1]
           + 0.0721 * data[..., 2]).astype(np.float64)
    row_sums = lum.sum(axis=1)
    total = float(lum.sum())
    cdf_cond = np.cumsum(lum, axis=1) / np.where(row_sums > 0.0, row_sums,
                                                 1.0)[:, None]
    cdf_marg = np.cumsum(row_sums)
    if total > 0:
        cdf_marg = cdf_marg / total
    rows = np.searchsorted(cdf_marg, (np.arange(h) + 1.0) / h, side="left")
    marginal = ((np.clip(rows, 0, h - 1) + 0.5) / h).astype(np.float32)
    targets_x = (np.arange(w) + 1.0) / w
    cols = np.stack([np.searchsorted(cdf_cond[y], targets_x, side="left")
                     for y in range(h)])
    conditional = ((np.clip(cols, 0, w - 1) + 0.5) / w).astype(np.float32)
    return marginal, conditional, total


def build_equirect_env(data: np.ndarray, max_mip_levels: int | None = None,
                       device=None) -> EquirectEnv:
    """The environment of an (H, W, 3) HDR image on ``device`` (``cuda``
    unless another device is asked for). The image is clipped to the
    float16 range and stored as float16, the reference's HalfFloatType
    textures; the CDFs are built from those same values, by the C++
    library when it builds (``native.available()``), else by numpy."""
    from .. import native
    from ..composer import resolve_device

    dev = resolve_device(device)
    data = np.clip(np.asarray(data, np.float32), 0.0, 65504.0)
    data = data.astype(np.float16).astype(np.float32)
    tables = native.build_equirect_cdf(data)
    marginal, conditional, total = tables if tables is not None \
        else _cdf_numpy(data)
    base = torch.from_numpy(data)
    atlas = build_mip_atlas(base)
    return EquirectEnv(
        mips=tuple(m.to(torch.float16).to(dev)
                   for m in build_mip_chain(base, max_levels=max_mip_levels)),
        atlas=MipAtlas(atlas.data.to(torch.float16).to(dev), atlas.shapes),
        marginal=torch.from_numpy(np.asarray(marginal)).to(dev),
        conditional=torch.from_numpy(np.asarray(conditional)).to(dev),
        total_sum=torch.tensor(total, dtype=torch.float32, device=dev),
        cdf_packed=torch.from_numpy(_build_cdf_packed(
            data, np.asarray(marginal), np.asarray(conditional))).to(dev),
    )


def procedural_sky(height: int = 64, width: int = 128, sun_dir=(0.5, 0.6, 0.3),
                   sun_intensity: float = 40.0, sky_tint=(0.35, 0.55, 0.95),
                   ground_tint=(0.25, 0.22, 0.2)) -> np.ndarray:
    """Analytic HDR sky, (H, W, 3) float32: gradient + sun disk."""
    v, u = np.meshgrid((np.arange(height) + 0.5) / height,
                       (np.arange(width) + 0.5) / width, indexing="ij")
    theta = (u - 0.5) * 2.0 * np.pi
    phi = (1.0 - v) * np.pi
    d = np.stack([np.sin(phi) * np.cos(theta), np.cos(phi),
                  np.sin(phi) * np.sin(theta)], axis=-1)
    sun = np.asarray(sun_dir, np.float64)
    sun /= np.linalg.norm(sun)
    cos_sun = (d * sun).sum(-1)
    up = np.clip(d[..., 1], -1.0, 1.0)
    sky = np.asarray(sky_tint)[None, None] * (0.4 + 0.6 * np.clip(up, 0, 1))[..., None]
    ground = np.asarray(ground_tint)[None, None] * (0.3 - 0.2 * np.clip(up, -1, 0))[..., None]
    base = np.where(up[..., None] >= 0.0, sky, ground)
    sun_disk = sun_intensity * np.clip(cos_sun - 0.995, 0.0, 1.0)[..., None] * 200.0
    halo = 0.5 * np.clip(cos_sun, 0.0, 1.0)[..., None] ** 8
    return (base + sun_disk + halo).astype(np.float32)
