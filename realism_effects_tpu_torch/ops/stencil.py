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

On the H100 a thread a pixel with direct loads was bound by instruction
issue (25 taps of 4 loads and 8 NaN-checked min/max a pixel at r = 2),
not by bytes. The kernel takes the window as a row pass over a 32 x 16
tile and its r-halo rows into shared memory, with the validity rule
folded in as each texel is loaded, and a column pass (2(2r+1)
comparisons a channel, not (2r+1)^2). Any radius runs: the row pass is
sized from r, and above the card's opt-in shared-memory limit the
kernel loads each tap directly. The result equals the plain version bit
for bit.

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

import numpy as np
import torch
import torch.nn.functional as F

from ..core.math3d import fma
from . import cuda_build

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
    """(min, max), each (H, W, C), of ``tex`` (H, W, C<=8) float32.
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    if tex.device.type == "cpu":
        return neighborhood_minmax_plain(tex, radius)
    return _launch(tex, radius)


def _launch(tex, radius):
    h, w, c = tex.shape
    if c > 8:
        raise ValueError(f"neighborhood_minmax takes at most 8 channels, not {c}")
    tex = tex.contiguous()
    cuda_build.require_cuda(tex)
    mn = torch.empty_like(tex)
    mx = torch.empty_like(tex)
    cuda_build.launch("minmax", "stencil", "re_minmax", (3, 4), tex,
                      tex.data_ptr(), mn.data_ptr(), mx.data_ptr(), h, w, c,
                      int(radius))
    return mn, mx


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
    ``sharpness``. CUDA tensors launch the kernel; CPU tensors take the
    plain version."""
    if color.device.type == "cpu":
        return sharpness_3x3_plain(color, sharpness)
    return _launch_sharpness(color, sharpness)


def _launch_sharpness(color, sharpness):
    h, w, c = color.shape
    if c > 4:
        raise ValueError(f"sharpness_3x3 takes at most 4 channels, not {c}")
    if h * w * c >= 1 << 31:
        raise ValueError(f"sharpness_3x3 takes fewer than 2^31 floats, not {h * w * c}")
    color = color.contiguous()
    cuda_build.require_cuda(color)
    out = torch.empty_like(color)
    params = np.array([sharpness], np.float32)
    cuda_build.launch("sharpness", "stencil", "re_sharpness", (2, 3, 1), color,
                      color.data_ptr(), out.data_ptr(), h, w, c, params.ctypes.data)
    return out
