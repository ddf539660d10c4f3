"""FXAA 3.11, quality preset 12 (the reference demo's fallback AA,
``POSTPROCESSING.FXAAEffect``, `main.js:116-154,543-559`), the JAX
package's ``effects/fxaa.py``: luma edge detection on the edge-clamped
3x3 neighbourhood, sub-pixel filtering, and the end-of-edge search as
whole-image bilinear fetches, one a step and side.
"""

from __future__ import annotations

import torch

from ..core.math3d import uv_grid
from ..core.sampling import sample_bilinear
from .base import Effect

#: FXAA 3.11 PRESET 12 search-step offsets
_STEPS = (1.0, 1.5, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 4.0, 8.0)

_EDGE_THRESHOLD = 0.0312       # contrast floor (FXAA_QUALITY level 12)
_EDGE_THRESHOLD_REL = 0.125    # relative contrast threshold
_SUBPIX = 0.75                 # sub-pixel aliasing removal strength


def _luma(rgb: torch.Tensor) -> torch.Tensor:
    return rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114


def fxaa(color: torch.Tensor) -> torch.Tensor:
    """FXAA 3.11 quality on an (H, W, 3) image (the demo runs it on the
    tone-mapped frame)."""
    h, w = color.shape[:2]
    dev = color.device
    inv = torch.tensor([1.0 / w, 1.0 / h], device=dev)
    uv = uv_grid(h, w, dev)
    luma = _luma(color)
    rows = torch.arange(h, device=dev)
    cols = torch.arange(w, device=dev)

    def nb(dy, dx):
        """luma[y + dy, x + dx], clamped at the border as a texture fetch
        is (a wrap would blend across the frame)."""
        return luma[(rows + dy).clamp(0, h - 1)][:, (cols + dx).clamp(0, w - 1)]

    l_c = luma
    l_n, l_s, l_w, l_e = nb(-1, 0), nb(1, 0), nb(0, -1), nb(0, 1)
    l_nw, l_ne, l_sw, l_se = nb(-1, -1), nb(-1, 1), nb(1, -1), nb(1, 1)

    l_min = torch.minimum(l_c, torch.minimum(torch.minimum(l_n, l_s),
                                             torch.minimum(l_w, l_e)))
    l_max = torch.maximum(l_c, torch.maximum(torch.maximum(l_n, l_s),
                                             torch.maximum(l_w, l_e)))
    contrast = l_max - l_min
    active = contrast >= torch.clamp(l_max * _EDGE_THRESHOLD_REL, min=_EDGE_THRESHOLD)

    # sub-pixel blend factor (lowpass against the centre's contrast)
    lowpass = (2.0 * (l_n + l_s + l_w + l_e) + l_nw + l_ne + l_sw + l_se) / 12.0
    sub = torch.clamp((lowpass - l_c).abs() / torch.clamp(contrast, min=1e-6),
                      0.0, 1.0)
    sub = (sub * sub) * (3.0 - 2.0 * sub)
    sub = sub * sub * _SUBPIX

    # edge orientation
    edge_h = ((l_nw + l_ne - 2.0 * l_n).abs()
              + 2.0 * (l_w + l_e - 2.0 * l_c).abs()
              + (l_sw + l_se - 2.0 * l_s).abs())
    edge_v = ((l_nw + l_sw - 2.0 * l_w).abs()
              + 2.0 * (l_n + l_s - 2.0 * l_c).abs()
              + (l_ne + l_se - 2.0 * l_e).abs())
    horizontal = edge_h >= edge_v

    # the higher-contrast side across the edge
    l_pos = torch.where(horizontal, l_s, l_e)
    l_neg = torch.where(horizontal, l_n, l_w)
    grad_pos = (l_pos - l_c).abs()
    grad_neg = (l_neg - l_c).abs()
    pos_side = grad_pos >= grad_neg
    pair_dir = torch.where(pos_side, 1.0, -1.0)
    l_edge = torch.where(pos_side, (l_pos + l_c) * 0.5, (l_neg + l_c) * 0.5)
    grad = torch.maximum(grad_pos, grad_neg) * 0.25

    # half a texel across onto the edge, then search along it
    zero = torch.zeros_like(pair_dir)
    perp = torch.where(horizontal[..., None], torch.stack([zero, pair_dir], -1),
                       torch.stack([pair_dir, zero], -1))
    along = torch.where(horizontal[..., None], torch.tensor([1.0, 0.0], device=dev),
                        torch.tensor([0.0, 1.0], device=dev))
    base = perp * 0.5

    dist_p = torch.zeros_like(l_c)
    dist_n = torch.zeros_like(l_c)
    done_p = torch.zeros_like(l_c, dtype=torch.bool)
    done_n = torch.zeros_like(l_c, dtype=torch.bool)
    end_p = torch.zeros_like(l_c)
    end_n = torch.zeros_like(l_c)
    off_p = torch.zeros_like(l_c)
    off_n = torch.zeros_like(l_c)
    for s in _STEPS:
        off_p = torch.where(done_p, off_p, off_p + s)
        off_n = torch.where(done_n, off_n, off_n + s)
        lp = _luma(sample_bilinear(color, uv + (base + along * off_p[..., None]) * inv))
        ln = _luma(sample_bilinear(color, uv + (base - along * off_n[..., None]) * inv))
        new_p = (lp - l_edge).abs() >= grad
        new_n = (ln - l_edge).abs() >= grad
        end_p = torch.where(done_p, end_p, lp)
        end_n = torch.where(done_n, end_n, ln)
        dist_p = torch.where(done_p, dist_p, off_p)
        dist_n = torch.where(done_n, dist_n, off_n)
        done_p = done_p | new_p
        done_n = done_n | new_n

    # blend toward the nearer edge end if its luma steps the same way
    span = dist_p + dist_n
    nearer_p = dist_p < dist_n
    dist = torch.minimum(dist_p, dist_n)
    l_end = torch.where(nearer_p, end_p, end_n)
    good = ((l_end - l_edge) * (l_c - l_edge)) < 0.0
    edge_blend = torch.where(good, 0.5 - dist / torch.clamp(span, min=1e-6), 0.0)

    blend = torch.maximum(edge_blend, sub)
    out_uv = uv + perp * (blend * active)[..., None] * inv
    return torch.where(active[..., None], sample_bilinear(color, out_uv), color)


class FXAAEffect(Effect):
    """Single-pass FXAA stage (the demo's AA switch and slow-GPU
    fallback)."""

    name = "fxaa"

    def apply(self, ctx, color, state):
        return fxaa(color), state
