"""Buffer views: any G-buffer plane or the velocity buffer as an (H, W, 3)
image (the reference's ``outputTexture`` routing and
``GBufferDebugPass``, `GBufferDebugPass.js:41-53`)."""

from __future__ import annotations

import torch

from ..core.framebuffers import GBuffer, VelocityBuffer


def visualize_gbuffer(gbuffer: GBuffer, mode: str) -> torch.Tensor:
    """One G-buffer plane as (H, W, 3): diffuse, alpha, normal,
    roughness, metalness, emissive, depth or mesh_id (hashed hues, the
    background black)."""
    if mode == "diffuse":
        return gbuffer.diffuse[..., :3]
    if mode == "alpha":
        return gbuffer.diffuse[..., 3:4].repeat(1, 1, 3)
    if mode == "normal":
        return gbuffer.normal * 0.5 + 0.5
    if mode in ("roughness", "metalness", "depth"):
        return getattr(gbuffer, mode)[..., None].repeat(1, 1, 3)
    if mode == "emissive":
        return gbuffer.emissive
    if mode == "mesh_id":
        mid = gbuffer.mesh_id
        if mid is None:
            raise ValueError("this GBuffer carries no mesh_id plane")
        t = mid.to(torch.float32)
        rgb = torch.stack([torch.remainder(t * 0.6180339887, 1.0),
                           torch.remainder(t * 0.7548776662 + 0.33, 1.0),
                           torch.remainder(t * 0.5698402910 + 0.66, 1.0)], dim=-1)
        return torch.where((mid >= 0)[..., None], rgb * 0.8 + 0.2, 0.0)
    raise ValueError(f"unknown gbuffer debug mode: {mode}")


def visualize_velocity(buf: VelocityBuffer, scale: float = 10.0) -> torch.Tensor:
    """Velocity as RG (scaled, centred at 0.5), depth in B."""
    vel = torch.clamp(buf.velocity * scale + 0.5, 0.0, 1.0)
    return torch.cat([vel, buf.depth[..., None]], dim=-1)
