"""Fixed-window stencils: the neighborhood AABB min/max of the temporal
clamp (`reproject.frag:53-81`) and the 3x3 unsharp mask of
``SharpnessEffect`` (`SharpnessEffect.js:4-31`).

Kernels: ``csrc/stencil.cu``. They replace the JAX package's
``ops/pallas/stencil.py::_minmax_kernel`` (``neighborhood_minmax``) and
``_sharpness_kernel`` (``sharpness_3x3``).

``neighborhood_minmax``:
Per pixel and channel: min and max over the (2r+1)^2 window, where a
texel whose channel 0 is negative, or that lies outside the frame,
counts as +1e30 (min) / -1e30 (max). The seeding with the pixel's own
input colour stays with the caller.

``sharpness_3x3``: edge-replicated 3x3 box blur, then
``max(c + (c - blur) * s, 0)``, in the arithmetic of the JAX package's
Pallas kernel as XLA compiles it: the sum in the kernel's order (for the
rows above, at and below: ``acc = ((acc + left) + centre) + right``),
``blur = acc * (1/9)`` as a product, and the two multiply-adds
contracted, ``d = fma(-acc, 1/9, c)`` and ``out = fma(d, s, c)``. Any
other order or rounding differs from it by an ulp on a sixth of the
pixels. Bound by bytes. A thread owns 4 consecutive floats of the
flattened row and walks two rows down, keeping three
16-byte units of each of the rows above, at and below in registers, and
writes each row's 4 floats with one 16-byte store; where the image or
the output is not 16-byte aligned, or a row is not a whole number of
16-byte units, the same kernel moves each float on its own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.math3d import fma

BIG = 1e30


def neighborhood_minmax_plain(tex: torch.Tensor, radius: int):
    """The kernel's function in PyTorch (shifted slices)."""
    h, w = tex.shape[0], tex.shape[1]
    valid = (tex[..., 0] >= 0.0)[..., None]
    planar = lambda a: a.permute(2, 0, 1)[None]
    r = radius
    lo = F.pad(planar(torch.where(valid, tex, BIG)), (r, r, r, r), value=BIG)
    hi = F.pad(planar(torch.where(valid, tex, -BIG)), (r, r, r, r), value=-BIG)
    mn = mx = None
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            a = lo[..., dy: dy + h, dx: dx + w]
            b = hi[..., dy: dy + h, dx: dx + w]
            mn = a if mn is None else torch.minimum(mn, a)
            mx = b if mx is None else torch.maximum(mx, b)
    back = lambda a: a[0].permute(1, 2, 0).contiguous()
    return back(mn), back(mx)


def neighborhood_minmax(tex: torch.Tensor, radius: int):
    """(min, max), each (H, W, C), of ``tex`` (H, W, C<=8) float32."""
    return neighborhood_minmax_plain(tex, radius)


def sharpness_3x3_plain(color: torch.Tensor, sharpness: float) -> torch.Tensor:
    """The kernel's function in PyTorch (clamped-index slices)."""
    h, w = color.shape[0], color.shape[1]
    dev = color.device
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    left = torch.clamp(xs - 1, min=0)
    right = torch.clamp(xs + 1, max=w - 1)
    acc = torch.zeros_like(color)
    for dy in (-1, 0, 1):
        row = color[torch.clamp(ys + dy, 0, h - 1)]
        acc = acc + row[:, left] + row + row[:, right]
    d = fma(-acc, torch.full_like(acc, 1.0 / 9.0), color)
    return torch.clamp(fma(d, torch.full_like(d, float(sharpness)), color),
                       min=0.0)


def sharpness_3x3(color: torch.Tensor, sharpness: float) -> torch.Tensor:
    """Unsharp mask of ``color`` (H, W, C) float32 with strength
    ``sharpness``."""
    return sharpness_3x3_plain(color, sharpness)


