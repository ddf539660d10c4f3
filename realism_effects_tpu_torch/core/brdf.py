"""BRDF sampling helpers. This slice needs only the cosine-hemisphere
sampler shared with HBAO (`hbao_utils.glsl:84-92`,
`ssgi_utils.frag:183-191`)."""

from __future__ import annotations

import math

import torch

from .math3d import normalize


def cosine_sample_hemisphere(n: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted direction around normal ``n`` (..., 3) from two
    uniforms ``u`` (..., 2): ``b = normalize(cross(n, (0, 1, 1)))``,
    ``t = cross(b, n)``."""
    r = torch.sqrt(u[..., 0])
    theta = u[..., 1] * (2.0 * math.pi)
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    b = normalize(torch.stack([ny - nz, -nx, nx], dim=-1))
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    t = torch.stack([by * nz - bz * ny, bz * nx - bx * nz,
                     bx * ny - by * nx], dim=-1)
    k1 = (r * torch.sin(theta))[..., None]
    k2 = torch.sqrt(torch.clamp(1.0 - u[..., 0], min=0.0))[..., None]
    k3 = (r * torch.cos(theta))[..., None]
    return normalize(k1 * b + k2 * n + k3 * t)
