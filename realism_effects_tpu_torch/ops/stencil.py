"""Neighborhood AABB min/max for the temporal clamp
(`reproject.frag:53-81`).

Kernel: ``csrc/stencil.cu``. It replaces the JAX package's
``ops/pallas/stencil.py::_minmax_kernel`` (``neighborhood_minmax``).
Per pixel and channel: min and max over the (2r+1)^2 window, where a
texel whose channel 0 is negative, or that lies outside the frame,
counts as +1e30 (min) / -1e30 (max). The seeding with the pixel's own
input colour stays with the caller.

On the H100 the kernel is bound by bytes (C floats in, 2C out a pixel;
window re-reads hit L1/L2). One thread per pixel with direct loads; the
result equals the plain version bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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
    mn, mx = _launch(tex, radius)
    neighborhood_minmax.launches += 1
    return mn, mx


neighborhood_minmax.launches = 0


def _launch(tex, radius):
    h, w, c = tex.shape
    if c > 8:
        raise ValueError(f"neighborhood_minmax takes at most 8 channels, not {c}")
    tex = tex.contiguous()
    cuda_build.require_cuda(tex)
    mn = torch.empty_like(tex)
    mx = torch.empty_like(tex)
    fn = cuda_build.bind("stencil", "re_minmax", 3, 4)
    err = fn(tex.data_ptr(), mn.data_ptr(), mx.data_ptr(), h, w, c,
             int(radius), cuda_build.stream_ptr(tex))
    cuda_build.check(err, "minmax kernel")
    return mn, mx
