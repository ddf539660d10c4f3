"""Ambient occlusion: HBAO (`hbao.frag` + `hbao_utils.glsl`).

The per-pixel loop runs in the fused HBAO kernel (``ops/hbao_kernel.py``).
GTAO is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import math3d
from ..core.math3d import screen_to_world, uv_grid
from .hbao_kernel import hbao_fused


@dataclasses.dataclass(frozen=True)
class AOConfig:
    """Static knobs; same fields and defaults as the JAX package's
    (``defaultAOOptions``, `AOEffect.js:8-21`)."""

    spp: int = 8
    distance: float = 2.0
    distance_power: float = 1.0
    bias: float = 40.0
    thickness: float = 0.075
    animated_noise: bool = True
    #: use G-buffer normals instead of depth-derived ones
    use_normal_texture: bool = True
    #: sampling window of the depth taps, +-window_ky rows x +-window_kx
    #: columns: a sample beyond it fetches at the window edge (the
    #: sampling radius is clamped in screen space)
    window_ky: int = 32
    window_kx: int = 32


def depth_world_normals(depth: torch.Tensor, cam) -> torch.Tensor:
    """World normals from the depth buffer via the 9-tap curvature-aware
    stencil (`hbao_utils.glsl:46-68`). Returns (H, W, 3)."""
    h, w = depth.shape
    uv = uv_grid(h, w, depth.device)

    def world_pos(d, uvx):
        return screen_to_world(uvx, d, cam.camera_matrix_world,
                               cam.projection_matrix_inverse)

    pad = torch.nn.functional.pad(depth[None, None], (2, 2, 2, 2),
                                  mode="replicate")[0, 0]
    sh = lambda dy, dx: pad[2 + dy: 2 + dy + h, 2 + dx: 2 + dx + w]
    c0 = depth
    l1, l2 = sh(0, -1), sh(0, -2)
    r1, r2 = sh(0, 1), sh(0, 2)
    b1, b2 = sh(-1, 0), sh(-2, 0)
    t1, t2 = sh(1, 0), sh(2, 0)
    dl = (2.0 * l1 - l2 - c0).abs()
    dr = (2.0 * r1 - r2 - c0).abs()
    db = (2.0 * b1 - b2 - c0).abs()
    dt = (2.0 * t1 - t2 - c0).abs()

    ce = world_pos(c0, uv)
    px = torch.tensor([1.0 / w, 0.0], device=depth.device)
    py = torch.tensor([0.0, 1.0 / h], device=depth.device)
    dpdx = torch.where((dl < dr)[..., None], ce - world_pos(l1, uv - px),
                       world_pos(r1, uv + px) - ce)
    dpdy = torch.where((db < dt)[..., None], ce - world_pos(b1, uv - py),
                       world_pos(t1, uv + py) - ce)
    return math3d.normalize(torch.linalg.cross(dpdx, dpdy))


def hbao(depth: torch.Tensor, normal: torch.Tensor | None, cam, frame: int,
         cfg: AOConfig):
    """HBAO. Returns (world normal (H, W, 3), ao (H, W)).

    ``normal``: world normals (G-buffer); None selects the depth-derived
    normals (`hbao_utils.glsl:70-79`)."""
    if normal is None or not cfg.use_normal_texture:
        world_normal = depth_world_normals(depth, cam)
    else:
        world_normal = normal
    return world_normal, hbao_fused(depth, world_normal, cam, frame, cfg)
