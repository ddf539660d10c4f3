"""Pointwise composition: `ao_compose.frag`, `ssgi_compose.frag`."""

from __future__ import annotations

import numpy as np
import torch

from ..core.math3d import depth_to_view_z, mix


def ao_compose(color: torch.Tensor, ao: torch.Tensor, depth: torch.Tensor,
               power: float = 2.0, ao_color=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """color * mix(aoColor, 1, ao^power); background (depth > 0.9999) is
    left un-occluded (`ao_compose.frag:6-17`)."""
    a = torch.where(depth > 0.9999, 1.0, ao) ** float(power)
    # mix(c, 1, a) per channel with c a host float32 scalar
    c32 = [np.float32(c) for c in ao_color]
    tint = torch.stack([float(c) + float(np.float32(1.0) - c) * a
                        for c in c32], dim=-1)
    return color * tint


def ssgi_compose(gi_color: torch.Tensor, scene_color: torch.Tensor,
                 depth: torch.Tensor, cam=None, fog_color=None,
                 fog_density: float = 0.0) -> torch.Tensor:
    """GI over the scene: the background shows the scene colour, the
    foreground the GI, faded into exp2 fog when ``fog_density > 0``
    (`ssgi_compose.frag:20-44`, with its 0.4 viewZ factor)."""
    out = torch.where(depth[..., None] >= 1.0, scene_color, gi_color)
    if fog_color is not None and fog_density > 0.0 and cam is not None:
        fog_depth = -(depth_to_view_z(depth, cam) * 0.4)
        fog_factor = 1.0 - torch.exp(-fog_density * fog_density
                                     * fog_depth * fog_depth)
        fog_factor = torch.where(depth >= 1.0, 0.0, fog_factor)
        fog = torch.stack([torch.full_like(depth, float(c)) for c in fog_color], -1)
        out = mix(out, fog, fog_factor[..., None])
    return out
