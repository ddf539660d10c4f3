"""Pointwise composition: `ao_compose.frag`."""

from __future__ import annotations

import numpy as np
import torch


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

