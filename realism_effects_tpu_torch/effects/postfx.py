"""Companion post-FX: ACES tone mapping, bloom, vignette, 3D LUT (the JAX
package's ``effects/postfx.py``).

The reference demo composes realism-effects with four effects of the
``postprocessing`` package; its full stack is ``EffectPass(ssgi,
toneMapping[ACES_FILMIC])`` -> ``EffectPass(traa)`` ->
``EffectPass(sharpness, vignette)`` -> ``EffectPass(bloom, lut)``
(`main.js:510-539`, bloom and vignette settings at `:465-476`). All four
are torch ops: pointwise (tone map, vignette, LUT) and a mip-chain
pyramid blur (bloom). Uniforms are combined in float32, as the JAX
package's float32 uniforms are.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.math3d import length, mix, smoothstep, uv_grid
from ..core.sampling import build_mip_chain, sample_bilinear
from .base import Effect
from .finishing import f32

# three.js ACESFilmicToneMapping (tonemapping_pars_fragment.glsl.js):
# RRT/ODT fit by Stephen Hill. GLSL mat3 constructors are column-major;
# these are the row-major equivalents.
_ACES_INPUT = np.array([
    [0.59719, 0.35458, 0.04823],
    [0.07600, 0.90834, 0.01566],
    [0.02840, 0.13383, 0.83777],
], np.float32)
_ACES_OUTPUT = np.array([
    [1.60475, -0.53108, -0.07367],
    [-0.10208, 1.10813, -0.00605],
    [-0.00327, -0.07276, 1.07602],
], np.float32)


def _mat3_apply(m: np.ndarray, c: torch.Tensor) -> torch.Tensor:
    """Per-channel weighted sums in index order, not a matmul: each
    product and sum rounds in float32 on the CPU and the card alike (a
    matmul could reorder the sum or run in TF32)."""
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    row = lambda i: float(m[i, 0]) * r + float(m[i, 1]) * g + float(m[i, 2]) * b
    return torch.stack([row(0), row(1), row(2)], dim=-1)


def aces_filmic(color: torch.Tensor, exposure: float = 1.0) -> torch.Tensor:
    """three.js ``ACESFilmicToneMapping`` (the postprocessing
    ``ToneMappingMode.ACES_FILMIC`` the reference demo selects,
    `main.js:513-514`)."""
    c = color * f32(np.float32(exposure) / np.float32(0.6))
    c = _mat3_apply(_ACES_INPUT, c)
    a = c * (c + 0.0245786) - 0.000090537
    b = c * (0.983729 * c + 0.4329510) + 0.238081
    return torch.clamp(_mat3_apply(_ACES_OUTPUT, a / b), 0.0, 1.0)


class ToneMappingEffect(Effect):
    """ACES-filmic tone mapping stage (`main.js:513-514`): after GI,
    before the LDR finishing chain."""

    name = "tonemapping"

    def __init__(self, exposure: float = 1.0):
        self.exposure = exposure

    def uniforms(self):
        return {"exposure": float(self.exposure)}

    def apply(self, ctx, color, state):
        return aces_filmic(color, ctx.params[self.name]["exposure"]), state


class VignetteEffect(Effect):
    """Radial darkening, postprocessing's default technique:
    ``color * smoothstep(0.8, offset * 0.799, d * (darkness + offset))``
    (the reference demo uses darkness 0.8, offset 0.3, `main.js:473-476`)."""

    name = "vignette"

    def __init__(self, offset: float = 0.3, darkness: float = 0.8):
        self.offset = offset
        self.darkness = darkness

    def uniforms(self):
        return {"offset": float(self.offset), "darkness": float(self.darkness)}

    def apply(self, ctx, color, state):
        u = ctx.params[self.name]
        off, dark = np.float32(u["offset"]), np.float32(u["darkness"])
        d = length(uv_grid(*color.shape[:2], color.device) - 0.5)
        # float32 edges: their difference rounds in float32, as the JAX
        # package's float32 uniforms do
        f = smoothstep(np.float32(0.8), off * np.float32(0.799), d * float(dark + off))
        return color * f[..., None], state


class BloomEffect(Effect):
    """Luminance-thresholded pyramid (mipmap) bloom: postprocessing's
    ``BloomEffect({mipmapBlur: true})`` the demo adds (`main.js:465-471`).
    A soft-knee prefilter ``smoothstep(threshold, threshold + smoothing,
    l)``, a 2x2 box pyramid of ``levels`` levels, and progressive
    bilinear upsampling blended by ``radius`` (``mix(base, up, radius)``),
    added back scaled by ``intensity``."""

    name = "bloom"

    def __init__(self, intensity: float = 1.0,
                 luminance_threshold: float = 0.75,
                 luminance_smoothing: float = 0.5,
                 radius: float = 0.85, levels: int = 8):
        self.intensity = intensity
        self.luminance_threshold = luminance_threshold
        self.luminance_smoothing = luminance_smoothing
        self.radius = radius
        self.levels = levels

    def uniforms(self):
        return {"intensity": float(self.intensity),
                "threshold": float(self.luminance_threshold),
                "smoothing": float(self.luminance_smoothing),
                "radius": float(self.radius)}

    def static_key(self):
        return ("levels", self.levels)

    def apply(self, ctx, color, state):
        u = ctx.params[self.name]
        th = np.float32(u["threshold"])
        # postprocessing's LuminanceMaterial: relative luminance + soft knee
        lum = color[..., 0] * 0.2126 + color[..., 1] * 0.7152 + color[..., 2] * 0.0722
        gate = smoothstep(th, th + np.float32(u["smoothing"]), lum)
        mips = build_mip_chain(color * gate[..., None], max_levels=self.levels)
        acc = mips[-1]
        for level in mips[-2::-1]:
            h, w = level.shape[:2]
            acc = mix(level, sample_bilinear(acc, uv_grid(h, w, color.device)),
                      f32(u["radius"]))
        return color + acc * f32(u["intensity"]), state


def load_lut_3dl(path: str) -> np.ndarray:
    """Parse an Autodesk .3dl LUT into an (S, S, S, 3) float32 cube in
    [0, 1], indexed ``lut[r, g, b]``: '#' comments, one line of S
    input-grid breakpoints, then S^3 ``R G B`` rows with blue varying
    fastest, in the 12-bit 0..4095 domain (the ``LUT3dlLoader`` format of
    the demo's ``lut_v2.3dl``, `main.js:510-512`)."""
    rows = []
    grid = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = line.split()
            if grid is None:
                grid = np.asarray(vals, np.float32)
                continue
            rows.append(vals)
    size = len(grid)
    if len(rows) != size ** 3:
        raise ValueError(f"3dl: expected {size ** 3} entries, found {len(rows)}")
    data = np.asarray(rows, np.float32) / 4095.0
    return data.reshape(size, size, size, 3)


class LUT3DEffect(Effect):
    """3D colour-grading LUT (postprocessing ``LUT3DEffect``,
    `main.js:510-512`), in the tone-mapped [0, 1] domain: trilinear fetch
    from the (S, S, S, 3) cube."""

    name = "lut"

    def __init__(self, lut: np.ndarray):
        self.lut = np.asarray(lut, np.float32)
        self._flat = {}   # the cube on each device, (S^3, 3)

    def static_key(self):
        return ("size", self.lut.shape[0])

    def apply(self, ctx, color, state):
        s = self.lut.shape[0]
        flat = self._flat.get(color.device)
        if flat is None:
            flat = torch.as_tensor(self.lut.reshape(-1, 3), device=color.device)
            self._flat[color.device] = flat
        c = torch.clamp(color, 0.0, 1.0) * float(s - 1)
        lo = torch.clamp(torch.floor(c).to(torch.int32), max=s - 2)
        f = c - lo
        r0, g0, b0 = lo[..., 0].long(), lo[..., 1].long(), lo[..., 2].long()

        def fetch(dr, dg, db):
            return flat[((r0 + dr) * s + (g0 + dg)) * s + (b0 + db)]

        c00 = mix(fetch(0, 0, 0), fetch(1, 0, 0), f[..., 0:1])
        c10 = mix(fetch(0, 1, 0), fetch(1, 1, 0), f[..., 0:1])
        c01 = mix(fetch(0, 0, 1), fetch(1, 0, 1), f[..., 0:1])
        c11 = mix(fetch(0, 1, 1), fetch(1, 1, 1), f[..., 0:1])
        return mix(mix(c00, c10, f[..., 1:2]), mix(c01, c11, f[..., 1:2]),
                   f[..., 2:3]), state
