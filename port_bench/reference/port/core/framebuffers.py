"""Framebuffers: the struct-of-arrays G-buffer and velocity buffer, as
dataclasses of float32 tensors (same planes and layouts as the JAX
package's ``core/framebuffers.py``)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class GBuffer:
    """Struct-of-arrays G-buffer (all float32)."""

    diffuse: torch.Tensor     # (H, W, 4) rgba albedo
    normal: torch.Tensor      # (H, W, 3) world-space unit normal, 0 = none
    roughness: torch.Tensor   # (H, W)
    metalness: torch.Tensor   # (H, W)
    emissive: torch.Tensor    # (H, W, 3)
    depth: torch.Tensor       # (H, W) depth-buffer value in [0, 1]
    mesh_id: torch.Tensor | None = None  # (H, W) int32, -1 = background
    ao: torch.Tensor | None = None       # (H, W) baked aoMap term

    @property
    def height(self) -> int:
        return self.depth.shape[0]

    @property
    def width(self) -> int:
        return self.depth.shape[1]

    @property
    def device(self) -> torch.device:
        return self.depth.device

    def replace(self, **changes) -> "GBuffer":
        return dataclasses.replace(self, **changes)

    @classmethod
    def background(cls, height: int, width: int, device=None) -> "GBuffer":
        """Empty G-buffer: depth 1 everywhere (background), on ``device``
        (``cuda`` unless another device is asked for)."""
        from ..composer import resolve_device

        device = resolve_device(device)
        z = lambda *s: torch.zeros((height, width) + s, device=device)
        return cls(
            diffuse=z(4), normal=z(3),
            roughness=torch.ones((height, width), device=device),
            metalness=z(), emissive=z(3),
            depth=torch.ones((height, width), device=device),
        )


@dataclasses.dataclass(frozen=True)
class VelocityBuffer:
    """Output of the velocity/depth/normal pass. ``velocity`` is the uv
    displacement current - previous frame, so ``uv - velocity`` reprojects
    into the previous frame (`reproject.frag:204`)."""

    velocity: torch.Tensor  # (H, W, 2)
    normal: torch.Tensor    # (H, W, 3) world-space normal
    depth: torch.Tensor     # (H, W) depth in [0, 1]

    @property
    def height(self) -> int:
        return self.depth.shape[0]

    @property
    def width(self) -> int:
        return self.depth.shape[1]

    @classmethod
    def zeros(cls, height: int, width: int, device=None) -> "VelocityBuffer":
        """No motion, depth 1, on ``device`` (``cuda`` unless another
        device is asked for)."""
        from ..composer import resolve_device

        device = resolve_device(device)
        return cls(
            velocity=torch.zeros((height, width, 2), device=device),
            normal=torch.zeros((height, width, 3), device=device),
            depth=torch.ones((height, width), device=device),
        )
