"""Edge-aware spatio-temporal Poisson denoiser (`poisson_denoise.frag` +
`PoissonDenoisePass.js`): 8 rotated Poisson taps with normal, depth,
roughness and luma edge-stopping weights and disocclusion-age blending,
run as ``2 * iterations`` ping-pong passes.

By default each pass is one launch of the fused kernel
(``ops/poisson_kernel.py``). With ``poisson_kernel.USE_FUSED_PASS`` off
(or more than ``MAX_TEX`` textures) a pass runs the JAX package's unfused
formulation in torch ops, its tap fetches in the tap kernel
(``ops/poisson_taps.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from ..core.framebuffers import GBuffer
from ..core.math3d import floor_int32, fwidth, length, mix
from ..core.packing import (pack_half2x16, pack_normal, unpack_half2x16,
                            unpack_normal)
from ..core.rng import blue_noise_image
from . import poisson_kernel
from .poisson_kernel import poisson_pass_fused
from .poisson_taps import poisson_taps

# `poisson_denoise.frag:91-92`, float32 as in the JAX package's table
_SQRT2_4 = 0.25 * float(np.sqrt(2.0))
POISSON8 = np.array(
    [(-1.0, 0.0), (0.0, -1.0), (1.0, 0.0), (0.0, 1.0),
     (-_SQRT2_4, -_SQRT2_4), (_SQRT2_4, -_SQRT2_4),
     (_SQRT2_4, _SQRT2_4), (-_SQRT2_4, _SQRT2_4)], np.float32)


@dataclasses.dataclass(frozen=True)
class PoissonDenoiseConfig:
    """Same fields and defaults as the JAX package's
    (``defaultPoissonBlurOptions``, `PoissonDenoisePass.js:16-24`)."""

    iterations: int = 1
    radius: float = 3.0
    phi: float = 0.5
    luma_phi: float = 5.0
    depth_phi: float = 2.0
    normal_phi: float = 3.25
    roughness_phi: float = 50.0
    specular_phi: float = 50.0
    #: which input slots hold specular data
    is_specular: tuple = (False,)


def poisson_denoise_pass(textures: Sequence[torch.Tensor], gbuffer: GBuffer,
                         noise_index: int, cfg: PoissonDenoiseConfig,
                         row_offset: int = 0, resolution: tuple | None = None,
                         scalar_slots: tuple | None = None):
    """One 8-tap pass over all texture slots, (H, W, 4) in and out.

    ``row_offset``: the global row of this block's first row; a row block
    of a larger frame (a shard extended by halo rows) passes it so that
    the blue-noise phase is the whole frame's. ``resolution``: the global
    (H, W) the tap pattern is defined against (the offsets rotate in uv,
    so the pixel pattern depends on the whole frame's aspect); by default
    the block's own shape."""
    if poisson_kernel.USE_FUSED_PASS and len(textures) <= poisson_kernel.MAX_TEX:
        return poisson_pass_fused(textures, gbuffer, noise_index, cfg,
                                  row_offset=row_offset, resolution=resolution,
                                  scalar_slots=scalar_slots)
    return poisson_pass_unfused(textures, gbuffer, noise_index, cfg,
                                row_offset, resolution)


def _to_denoise_space(c):
    return torch.log(c + 1.0)


def _luminance8(rgb):
    """pow(luminance, 0.125) (`poisson_denoise.frag:28`)."""
    base = rgb[..., 0] * 0.2125 + rgb[..., 1] * 0.7154 + rgb[..., 2] * 0.0721
    return torch.clamp(base, min=0.0) ** 0.125


def poisson_pass_unfused(textures: Sequence[torch.Tensor], gbuffer: GBuffer,
                         noise_index: int, cfg: PoissonDenoiseConfig,
                         row_offset: int = 0, resolution: tuple | None = None):
    """One pass in the JAX package's unfused formulation and operation
    order (``ops/poisson_denoise.py:111-291``, one device): the packed
    normal (zero normals stay zero), textures read through float16,
    specular factor, flatness, the noise angle; the 8 tap texels of
    every pixel from the rotated, aspect-scaled uv offsets; one packed
    bundle [depth | oct-normal | roughness | 2 half2x16 a texture]
    fetched at them by :func:`poisson_taps` (more than 2 textures: the
    decoded normal, depth and roughness, and each texture, fetched
    apiece); then the edge-stopping weights, the log-space accumulation
    and the background kept. Scalar slots are not packed here. A row
    block takes ``row_offset`` and ``resolution`` as
    :func:`poisson_denoise_pass` does: the tap uvs, the snap and the frame
    clamp are the global frame's, and a tap row is re-based onto the
    block."""
    h, w = gbuffer.depth.shape
    hg, wg = resolution if resolution is not None else (h, w)
    dev = gbuffer.depth.device
    depth = gbuffer.depth
    n_valid = gbuffer.normal.abs().sum(-1, keepdim=True) > 1e-8
    packed_nrm = torch.where(n_valid[..., 0], pack_normal(gbuffer.normal), 0.0)
    normal = torch.where(n_valid, unpack_normal(packed_nrm), 0.0)
    roughness = gbuffer.roughness
    is_background = depth >= 1.0
    textures = [t.to(torch.float16).to(torch.float32) for t in textures]

    glossiness = torch.clamp(4.0 * (1.0 - roughness / 0.25), min=0.0)
    specular_factor = torch.exp(-glossiness * cfg.specular_phi)
    flatness = 1.0 - torch.clamp(length(fwidth(normal)), max=1.0)
    flatness = flatness ** 2.0 * 0.75 + 0.25

    noise = blue_noise_image(h, w, noise_index, row_offset=row_offset,
                             device=dev)
    angle = noise[..., 0] * 2.0 * math.pi
    s, c = torch.sin(angle), torch.cos(angle)
    rscale = cfg.radius * flatness

    center = []
    for tex in textures:
        t_rgb = _to_denoise_space(tex[..., :3] * 1.0003)
        center.append({
            "rgb": t_rgb, "a": tex[..., 3], "lum": _luminance8(t_rgb),
            "w": 1.0 / (tex[..., 3] + 1.0) ** (1.2 * cfg.phi),
            "total": torch.ones_like(depth), "acc": t_rgb,
        })

    n_tex = len(textures)
    if 3 + 2 * n_tex <= 8:
        slots = [depth, packed_nrm, roughness]
        for t in textures:
            slots += [pack_half2x16(t[..., 0:2]), pack_half2x16(t[..., 2:4])]
        bundle = torch.stack(slots, dim=-1)
    else:
        bundle = torch.cat([normal, depth[..., None], roughness[..., None]], -1)

    # tap texels: neighbourUv = vUv + rm * (offset / resolution), with
    # rm = r * flatness * mat2(c, -s, s, c) (`poisson_denoise.frag:185-190`)
    u = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / wg
    v = (torch.arange(h, dtype=torch.float32, device=dev) + row_offset + 0.5) / hg
    iys, ixs = [], []
    for off in POISSON8:
        ox = (c * (off[0] / np.float32(wg)) + s * (off[1] / np.float32(hg))) * rscale
        oy = (-s * (off[0] / np.float32(wg)) + c * (off[1] / np.float32(hg))) * rscale
        ixs.append(torch.clamp(floor_int32((u[None, :] + ox) * wg), 0, wg - 1))
        iy = torch.clamp(floor_int32((v[:, None] + oy) * hg), 0, hg - 1)
        iys.append(torch.clamp(iy - row_offset, 0, h - 1))
    iy, ix = torch.stack(iys), torch.stack(ixs)
    taps = poisson_taps(bundle, iy, ix)
    tex_taps = (None if 3 + 2 * n_tex <= 8
                else [poisson_taps(t, iy, ix) for t in textures])

    for k in range(8):
        b = taps[k]
        if tex_taps is None:
            n_depth, n_rough = b[..., 0], b[..., 2]
            n_normal = unpack_normal(b[..., 1])
            n_texs = [torch.cat([unpack_half2x16(b[..., 3 + 2 * i]),
                                 unpack_half2x16(b[..., 4 + 2 * i])], -1)
                      for i in range(n_tex)]
        else:
            n_normal, n_depth, n_rough = b[..., :3], b[..., 3], b[..., 4]
            n_texs = [t[k] for t in tex_taps]
        normal_diff = 1.0 - torch.clamp((normal * n_normal).sum(-1), min=0.0)
        depth_diff = 10000.0 * (depth - n_depth).abs()
        rough_diff = (roughness - n_rough).abs()
        w_basic = torch.exp(-normal_diff * cfg.normal_phi
                            - depth_diff * cfg.depth_phi
                            - rough_diff * cfg.roughness_phi)
        w_basic = torch.where(n_depth >= 1.0, 0.0, w_basic)
        for i, st in enumerate(center):
            wgt = w_basic * (specular_factor if cfg.is_specular[i] else 1.0)
            t_rgb = _to_denoise_space(torch.clamp(n_texs[i][..., :3], min=0.0))
            disoccl_w = torch.clamp(wgt, min=1e-20) ** 0.1
            luma_diff = torch.clamp((st["lum"] - _luminance8(t_rgb)).abs(), max=0.5)
            luma_factor = torch.exp(-luma_diff * cfg.luma_phi)
            wgt = mix(wgt * luma_factor, disoccl_w, st["w"]) * st["w"]
            wgt = wgt * (wgt >= 0.0001)
            st["acc"] = st["acc"] + wgt[..., None] * t_rgb
            st["total"] = st["total"] + wgt

    outputs = []
    for tex, st in zip(textures, center):
        rgb = torch.exp(st["acc"] / st["total"][..., None]) - 1.0
        out = torch.cat([rgb, st["a"][..., None]], -1)
        outputs.append(torch.where(is_background[..., None], tex, out))
    return outputs


def poisson_denoise(textures: Sequence[torch.Tensor], gbuffer: GBuffer,
                    frame: int, cfg: PoissonDenoiseConfig,
                    row_offset: int = 0, resolution: tuple | None = None,
                    scalar_slots: tuple | None = None):
    """Full denoise: ``2 * iterations`` passes (the A/B ping-pong of
    `PoissonDenoisePass.js:135-149`); pass p of frame f draws noise
    index ``f * 2 * iterations + p``. ``row_offset`` and ``resolution``
    as in :func:`poisson_denoise_pass`."""
    out = list(textures)
    for p in range(2 * cfg.iterations):
        out = poisson_denoise_pass(out, gbuffer,
                                   frame * 2 * cfg.iterations + p, cfg,
                                   row_offset=row_offset, resolution=resolution,
                                   scalar_slots=scalar_slots)
    return out


def ao_texture(ao: torch.Tensor) -> torch.Tensor:
    """The AO plane as the denoiser's texture: replicated to rgb, zero
    alpha."""
    return torch.cat([ao[..., None].expand(*ao.shape, 3),
                      torch.zeros_like(ao)[..., None]], dim=-1)


def ao_config(cfg: PoissonDenoiseConfig) -> PoissonDenoiseConfig:
    return dataclasses.replace(cfg, is_specular=(False,))


def poisson_denoise_ao(ao: torch.Tensor, normal: torch.Tensor,
                       gbuffer: GBuffer, frame: int,
                       cfg: PoissonDenoiseConfig) -> torch.Tensor:
    """AO denoise: the scalar AO rides one packed channel (replicated to
    rgb, zero alpha), with normal and depth edge-stopping weights."""
    (out,) = poisson_denoise([ao_texture(ao)], gbuffer, frame, ao_config(cfg),
                             scalar_slots=(True,))
    return torch.clamp(out[..., 0], 0.0, 1.0)
