"""Edge-aware spatio-temporal Poisson denoiser (`poisson_denoise.frag` +
`PoissonDenoisePass.js`): 8 rotated Poisson taps with normal, depth,
roughness and luma edge-stopping weights and disocclusion-age blending,
run as ``2 * iterations`` ping-pong passes. Each pass is one launch of
the fused kernel (``ops/poisson_kernel.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..core.framebuffers import GBuffer
from .poisson_kernel import poisson_pass_fused


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
                         scalar_slots: tuple | None = None):
    """One 8-tap pass over all texture slots, (H, W, 4) in and out."""
    return poisson_pass_fused(textures, gbuffer, noise_index, cfg,
                              scalar_slots=scalar_slots)


def poisson_denoise(textures: Sequence[torch.Tensor], gbuffer: GBuffer,
                    frame: int, cfg: PoissonDenoiseConfig,
                    scalar_slots: tuple | None = None):
    """Full denoise: ``2 * iterations`` passes (the A/B ping-pong of
    `PoissonDenoisePass.js:135-149`); pass p of frame f draws noise
    index ``f * 2 * iterations + p``."""
    out = list(textures)
    for p in range(2 * cfg.iterations):
        out = poisson_denoise_pass(out, gbuffer,
                                   frame * 2 * cfg.iterations + p, cfg,
                                   scalar_slots=scalar_slots)
    return out


def poisson_denoise_ao(ao: torch.Tensor, normal: torch.Tensor,
                       gbuffer: GBuffer, frame: int,
                       cfg: PoissonDenoiseConfig) -> torch.Tensor:
    """AO denoise: the scalar AO rides one packed channel (replicated to
    rgb, zero alpha), with normal and depth edge-stopping weights."""
    tex = torch.cat([ao[..., None].expand(*ao.shape, 3),
                     torch.zeros_like(ao)[..., None]], dim=-1)
    cfg1 = dataclasses.replace(cfg, is_specular=(False,))
    (out,) = poisson_denoise([tex], gbuffer, frame, cfg1,
                             scalar_slots=(True,))
    return torch.clamp(out[..., 0], 0.0, 1.0)
