"""Tap fetch of the Poisson denoiser's unfused pass: the 8 rotated taps
of every pixel read from one packed bundle.

Kernel: ``csrc/taps.cu``. It replaces the JAX package's
``ops/pallas/poisson_taps.py::_taps_kernel`` (``poisson_taps_dense``),
whose dense select over a static window around each pixel is
bit-identical to the clamped nearest gather. The port does the gather
itself, so it needs no window and has no limit on the window's size (the
TPU kernel refuses windows above 256 candidates, an unrolling limit).

On the H100 the kernel is bound by bytes (two int32 targets in, C floats
out a tap and pixel). A block owns a 32 x 8 pixel tile and its taps: it
loads each (tap, pixel)'s targets once, gathers the C floats into shared
memory as the output's contiguous runs, and writes those with 16-byte
stores. Indices are 32-bit, so the launch refuses ``N * H * W * C >=
2^31``.
"""

from __future__ import annotations

import torch

from . import cuda_build


def poisson_taps_plain(bundle: torch.Tensor, iy: torch.Tensor,
                       ix: torch.Tensor) -> torch.Tensor:
    """The kernel's function in PyTorch: ``bundle[iy[k], ix[k]]`` per tap,
    the targets clamped into the frame."""
    h, w = bundle.shape[0], bundle.shape[1]
    return bundle[torch.clamp(iy, 0, h - 1).long(), torch.clamp(ix, 0, w - 1).long()]


def poisson_taps(bundle: torch.Tensor, iy: torch.Tensor,
                 ix: torch.Tensor) -> torch.Tensor:
    """``bundle`` (H, W, C<=8) float32 at the int32 texels ``iy``, ``ix``
    (N, H, W): (N, H, W, C). CUDA tensors launch the kernel; CPU tensors
    take the plain version."""
    if bundle.device.type == "cpu":
        return poisson_taps_plain(bundle, iy, ix)
    return _launch(bundle, iy, ix)


def _launch(bundle, iy, ix):
    h, w, c = bundle.shape
    n = iy.shape[0]
    if tuple(iy.shape) != (n, h, w) or tuple(ix.shape) != (n, h, w):
        raise ValueError(f"targets of {tuple(iy.shape)} for a {h}x{w} bundle")
    if c > 8 or n * h * w * c >= 1 << 31:
        raise ValueError(f"poisson_taps takes at most 8 channels and 2^31 "
                         f"output floats, not {n}x{h}x{w}x{c}")
    args = [bundle.contiguous(), iy.to(torch.int32).contiguous(),
            ix.to(torch.int32).contiguous()]
    cuda_build.require_cuda(*args)
    out = torch.empty((n, h, w, c), dtype=torch.float32, device=bundle.device)
    cuda_build.launch("poisson_taps", "taps", "re_poisson_taps", (4, 4), bundle,
                      args[0].data_ptr(), args[1].data_ptr(), args[2].data_ptr(),
                      out.data_ptr(), h, w, c, n)
    return out
