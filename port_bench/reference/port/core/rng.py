"""Random / quasirandom sources.

- R2 plastic-number low-discrepancy sequence for camera jitter
  (`QuasirandomGenerator.js:11-24`).
- PCG4D hash + tiled blue-noise texture for per-pixel randomness
  (`blue_noise.glsl:9-48`).
- The Vogel spiral on the unit disk (GTAO's samples, `Utils.js:104-120`).

The frame index is a host int in this package, so the PCG4D shift of a
noise index is computed on the host in numpy ``uint32``; the device only
ever indexes the 128x128 tile at ``[(y + sy) % 128, (x + sx) % 128]``.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

# Plastic number constants (QuasirandomGenerator.js:11-14)
_G = 1.32471795724474602596090885447809
_A1 = 1.0 / _G
_A2 = 1.0 / (_G * _G)
_BASE = 1.1127756842787055  # harmoniousNumber(7)

BLUE_NOISE_SIZE = 128

_ASSET = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets", "blue_noise_128x128x4.npy",
)


def r2_sequence_point(n: int) -> tuple[float, float]:
    """n-th point of the R2 sequence in [0,1)^2."""
    return ((_BASE + _A1 * n) % 1.0, (_BASE + _A2 * n) % 1.0)


@functools.lru_cache(maxsize=1)
def blue_noise_tile() -> np.ndarray:
    """The (128, 128, 4) float32 blue-noise tile in [0, 1) from
    ``assets/``. Raises if the asset is missing: a regenerated tile would
    silently change every noise-driven value."""
    if not os.path.exists(_ASSET):
        raise FileNotFoundError(f"blue-noise asset missing: {_ASSET}")
    tile = np.load(_ASSET)
    tile.setflags(write=False)
    return tile


@functools.lru_cache(maxsize=8)
def _tile_on(device: str) -> torch.Tensor:
    return torch.as_tensor(np.array(blue_noise_tile()), device=device)


def blue_noise_tile_tensor(device) -> torch.Tensor:
    """The tile as a (128, 128, 4) float32 tensor, copied once per device."""
    return _tile_on(str(torch.device(device)))


def pcg4d(v: np.ndarray) -> np.ndarray:
    """PCG4D hash over uint32 ``(..., 4)`` (`blue_noise.glsl:17-28`)."""
    v = np.asarray(v, np.uint32)
    with np.errstate(over="ignore"):
        v = v * np.uint32(1664525) + np.uint32(1013904223)
        x, y, z, w = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
        x = x + y * w
        y = y + z * x
        z = z + x * y
        w = w + y * z
        v = np.stack([x, y, z, w], axis=-1)
        v = v ^ (v >> np.uint32(16))
        x, y, z, w = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
        x = x + y * w
        y = y + z * x
        z = z + x * y
        w = w + y * z
    return np.stack([x, y, z, w], axis=-1)


def noise_shift(index: int, row_offset: int = 0, col_offset: int = 0,
                size: int = BLUE_NOISE_SIZE) -> tuple[int, int]:
    """(sy, sx): blue-noise image ``index`` at pixel (y, x) is
    ``tile[(y + sy) % size, (x + sx) % size]``."""
    i = np.uint32(np.int64(index) & 0xFFFFFFFF)
    with np.errstate(over="ignore"):
        seed = np.array([i, i * np.uint32(15843),
                         i * np.uint32(31) + np.uint32(4566),
                         i * np.uint32(2345) + np.uint32(58585)], np.uint32)
    shift = pcg4d(seed)[:2] % np.uint32(0x0FFFFFFF)
    sx = (int(shift[0]) + int(col_offset)) % size
    sy = (int(shift[1]) + int(row_offset)) % size
    return sy, sx


def rolled_noise_tile(index: int, row_offset: int = 0, col_offset: int = 0,
                      tile: torch.Tensor | None = None,
                      device=None) -> torch.Tensor:
    """The pre-rolled (S, S, C) tile T with
    ``blue_noise_image(h, w, index, row_offset)[y, x] == T[y % S, x % S]``."""
    if tile is None:
        tile = blue_noise_tile_tensor(device or "cpu")
    sy, sx = noise_shift(index, row_offset, col_offset, tile.shape[0])
    return torch.roll(tile, shifts=(-sy, -sx), dims=(0, 1))


def blue_noise_image(height: int, width: int, index: int,
                     tile: torch.Tensor | None = None, row_offset: int = 0,
                     col_offset: int = 0, device=None) -> torch.Tensor:
    """Per-pixel (H, W, C) blue-noise values for noise ``index``
    (`blue_noise.glsl:37-48`): the tile fetched toroidally at the pixel
    coordinate shifted by a PCG4D hash of the index."""
    return blue_noise_transform(height, width, index, lambda t: t, tile,
                                row_offset, col_offset, device)


def blue_noise_transform(height: int, width: int, index: int, fn,
                         tile: torch.Tensor | None = None, row_offset: int = 0,
                         col_offset: int = 0, device=None) -> torch.Tensor:
    """``fn(blue_noise_image(h, w, index))`` for a POINTWISE ``fn``
    ((S, S, 4) tile -> (S, S, C)), evaluated on the 128x128 tile and then
    rolled and tiled: the same values for 128^2 evaluations of ``fn``
    instead of H * W."""
    if tile is None:
        tile = blue_noise_tile_tensor(device or "cpu")
    rolled = rolled_noise_tile(index, row_offset, col_offset, fn(tile))
    size = rolled.shape[0]
    reps_y = -(-height // size)
    reps_x = -(-width // size)
    return rolled.repeat(reps_y, reps_x, 1)[:height, :width]


def vogel_disk(count: int, phi_offset: float = 0.0) -> np.ndarray:
    """Vogel spiral distribution on the unit disk, as
    ``generateVogelDistribution`` (`Utils.js:104-120`): radius
    sqrt(i / n), golden-angle spiral, first point at the origin.
    Returns (count, 2) float32."""
    golden = np.pi * (3.0 - np.sqrt(5.0))
    i = np.arange(count, dtype=np.float64)
    r = np.sqrt(i / count)
    theta = i * golden + phi_offset
    return np.stack([r * np.cos(theta), r * np.sin(theta)], axis=-1).astype(np.float32)
