"""Finishing effects: sharpness, lens distortion, sparkle, gradual
background (the JAX package's ``effects/finishing.py``):

- `SharpnessEffect.js` -- 3x3 unsharp mask, through the sharpness kernel
  (``ops/stencil.py::sharpness_3x3``)
- `LensDistortionEffect.js` -- radial distortion + RGB chromatic
  aberration
- `SparkleEffect.js` -- procedural glints from world position / normal
  noise x luminance x facing
- `GradualBackgroundEffect.js` -- distance-based fade to a background
  colour

The last three are pointwise torch ops. Uniforms arrive as host floats
and are combined in float32, as the JAX package's float32 uniforms are.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import math3d
from ..core.math3d import (length, mix, normalize, screen_to_world,
                           smoothstep, transform_dir, uv_grid)
from ..core.sampling import sample_bilinear
from ..ops.stencil import sharpness_3x3
from .base import Effect


def f32(v) -> float:
    """A uniform rounded to float32 (as a Python float)."""
    return float(np.float32(v))


class SharpnessEffect(Effect):
    """3x3 unsharp mask, clamped >= 0 (`SharpnessEffect.js:4-31`)."""

    name = "sharpness"

    def __init__(self, sharpness: float = 1.0):
        self.sharpness = sharpness

    def uniforms(self):
        return {"sharpness": float(self.sharpness)}

    def apply(self, ctx, color, state):
        return sharpness_3x3(color, f32(ctx.params[self.name]["sharpness"])), state


class LensDistortionEffect(Effect):
    """Radial lens distortion + chromatic aberration
    (`LensDistortionEffect.js:14-45`)."""

    name = "lens_distortion"

    def __init__(self, alpha_x: float = -0.05, alpha_y: float = -0.05,
                 aberration: float = 1.0):
        self.alpha_x = alpha_x
        self.alpha_y = alpha_y
        self.aberration = aberration

    def uniforms(self):
        return {"alpha_x": float(self.alpha_x), "alpha_y": float(self.alpha_y),
                "aberration": float(self.aberration)}

    def apply(self, ctx, color, state):
        u = ctx.params[self.name]
        ax, ay, ab = f32(u["alpha_x"]), f32(u["alpha_y"]), np.float32(u["aberration"])
        h, w = color.shape[:2]
        uv = uv_grid(h, w, color.device)
        x = 2.0 * uv[..., 0] - 1.0
        y = 2.0 * uv[..., 1] - 1.0
        r = x * x + y * y
        # reverse radial transform (two Newton-ish steps, `:16-26`)
        x3 = x / (1.0 - ax * r)
        y3 = y / (1.0 - ay * r)
        r3 = x3 * x3 + y3 * y3
        x2 = x / (1.0 - ax * r3)
        y2 = y / (1.0 - ay * r3)
        duv = torch.stack([(x2 + 1.0) * 0.5, (y2 + 1.0) * 0.5], dim=-1)
        du = float(ab * np.float32(1.0 / w))
        dv = float(ab * np.float32(1.0 / h))
        off = lambda a, b: torch.tensor([a, b], dtype=torch.float32,
                                        device=color.device)
        rv = sample_bilinear(color, duv - off(du, 0.0))[..., 0]
        gv = sample_bilinear(color, duv - off(0.0, dv))[..., 1]
        bv = sample_bilinear(color, duv - off(du, dv))[..., 2]
        return torch.stack([rv, gv, bv], dim=-1), state


def _rand2(n: torch.Tensor) -> torch.Tensor:
    """GLSL-style hash rand(vec2) of the sparkle noise."""
    return torch.remainder(
        torch.sin(n[..., 0] * 12.9898 + n[..., 1] * 78.233) * 43758.5453, 1.0)


class SparkleEffect(Effect):
    """Procedural sparkle glints (`SparkleEffect.js:44-92`)."""

    name = "sparkle"

    def __init__(self, spread: float = 1.0, intensity: float = 1.0):
        self.spread = spread
        self.intensity = intensity

    def uniforms(self):
        return {"spread": float(self.spread), "intensity": float(self.intensity)}

    def apply(self, ctx, color, state):
        u = ctx.params[self.name]
        cam = ctx.unjittered_cam
        vel = ctx.velocity
        h, w = color.shape[:2]
        dev = color.device
        uv = uv_grid(h, w, dev)
        depth = vel.depth
        sky = (depth <= 0.0) | (depth >= 1.0)

        normal = vel.normal
        view_normal = normalize(transform_dir(cam.view_matrix, normal))
        world_pos = screen_to_world(uv, depth, cam.camera_matrix_world,
                                    cam.projection_matrix_inverse)
        low = world_pos[..., 1] < 0.01
        view_z = math3d.depth_to_view_z(depth, cam)
        view_pos = math3d.get_view_position(uv, view_z, cam.projection_matrix,
                                            cam.projection_matrix_inverse)
        view_dir = normalize(view_pos)
        cam_pos = torch.as_tensor(cam.position, dtype=torch.float32, device=dev)
        dist_factor = torch.exp(-length(world_pos - cam_pos) * 0.005)
        facing = torch.clamp(math3d.dot(-view_dir, view_normal), min=0.0) ** 4.0

        offset = (normalize(world_pos)[..., [0, 2]] * 1000.0
                  + normal[..., [0, 2]] * 500.0)
        # value-noise nn() (`:38-42`)
        b = torch.floor(offset)
        f = smoothstep(0.0, 1.0, offset - b)
        step = lambda dx, dy: torch.tensor([dx, dy], device=dev)
        d0 = _rand2(b)
        d1 = _rand2(b + step(1.0, 0.0))
        d2 = _rand2(b + step(0.0, 1.0))
        d3 = _rand2(b + step(1.0, 1.0))
        noise = mix(mix(d0, d1, f[..., 0]), mix(d2, d3, f[..., 0]), f[..., 1])
        noise = torch.clamp(noise, min=0.0) ** f32(500.0 * np.float32(u["spread"]))

        # Rec.601 weights here, unlike the other effects
        # (`SparkleEffect.js:5`: dot(c, vec3(0.299, 0.587, 0.114)))
        lum = color[..., 0] * 0.299 + color[..., 1] * 0.587 + color[..., 2] * 0.114
        lum = smoothstep(0.15, 1.0, lum)
        sparkle = (noise * lum * facing * dist_factor * 5000.0
                   * f32(u["intensity"]))
        out = color + (torch.clamp(color, min=0.0) ** 4.0) * sparkle[..., None]
        return torch.where((sky | low)[..., None], color, out), state


class GradualBackgroundEffect(Effect):
    """Distance-based fade to a background colour
    (`GradualBackgroundEffect.js:31-45`)."""

    name = "gradual_background"

    def __init__(self, background_color=(0.0, 0.0, 0.0), max_distance: float = 5.0):
        self.background_color = tuple(background_color)
        self.max_distance = max_distance

    def uniforms(self):
        return {"max_distance": float(self.max_distance)}

    def static_key(self):
        return (self.background_color,)

    def apply(self, ctx, color, state):
        cam = ctx.unjittered_cam
        h, w = color.shape[:2]
        world_pos = screen_to_world(uv_grid(h, w, color.device), ctx.gbuffer.depth,
                                    cam.camera_matrix_world,
                                    cam.projection_matrix_inverse)
        dist = length(world_pos[..., [0, 2]]) + torch.clamp(-world_pos[..., 1], min=0.0)
        fade = torch.clamp(
            torch.clamp(dist, min=1e-6) ** 0.1 * 15.0
            - f32(ctx.params[self.name]["max_distance"]), 0.0, 1.0)
        bg = torch.tensor(self.background_color, dtype=torch.float32,
                          device=color.device).expand(color.shape)
        return mix(color, bg, fade[..., None]), state
