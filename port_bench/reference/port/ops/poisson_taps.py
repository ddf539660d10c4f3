"""Tap fetch of the Poisson denoiser's unfused pass: the 8 rotated taps
of every pixel read from one packed bundle.

The plain version of the port's kernel ``csrc/taps.cu``, which replaces
the JAX package's
``ops/pallas/poisson_taps.py::_taps_kernel`` (``poisson_taps_dense``),
whose dense select over a static window around each pixel is
bit-identical to the clamped nearest gather. The port does the gather
itself, so it needs no window and has no limit on the window's size (the
TPU kernel refuses windows above 256 candidates, an unrolling limit).
"""

from __future__ import annotations

import torch



def poisson_taps_plain(bundle: torch.Tensor, iy: torch.Tensor,
                       ix: torch.Tensor) -> torch.Tensor:
    """The kernel's function in PyTorch: ``bundle[iy[k], ix[k]]`` per tap,
    the targets clamped into the frame."""
    h, w = bundle.shape[0], bundle.shape[1]
    return bundle[torch.clamp(iy, 0, h - 1).long(), torch.clamp(ix, 0, w - 1).long()]


def poisson_taps(bundle: torch.Tensor, iy: torch.Tensor,
                 ix: torch.Tensor) -> torch.Tensor:
    """``bundle`` (H, W, C<=8) float32 at the int32 texels ``iy``, ``ix``
    (N, H, W): (N, H, W, C)."""
    return poisson_taps_plain(bundle, iy, ix)


