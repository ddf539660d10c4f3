"""SMAA 1x (Jimenez et al. 2012; the reference demo's SMAA branch of its
AA switch, ``POSTPROCESSING.SMAAEffect``, `main.js:116-154,709-746`), the
JAX package's ``effects/smaa.py`` as whole-image passes:

1. luma edge detection, threshold 0.1, local contrast adaptation 2.0;
2. blend weights: each edge run's extents from int32 ``cummax`` scans,
   the revectorized line's coverage computed analytically (the area
   texture tabulates the same trapezoid integrals), L, Z and U patterns,
   and a diagonal pass for 45-degree staircases, revectorized to the
   midline through their corners;
3. neighbourhood blending with ``SMAANeighborhoodBlendingPS``'s
   bilinear-offset semantics.

For a horizontal boundary between pixel (y, x) and (y - 1, x), +y points
toward (y - 1, x); a crossing edge at a run end gives a corner at +0.5
on that row, -0.5 on the pixel's own row, none for both or neither.
"""

from __future__ import annotations

import torch

from .base import Effect

#: SMAA_THRESHOLD default
_THRESHOLD = 0.1
#: SMAA_LOCAL_CONTRAST_ADAPTATION_FACTOR
_CONTRAST_FACTOR = 2.0
#: SMAA_MAX_SEARCH_STEPS (run-length clamp, in pixels)
_MAX_SEARCH = 16
#: SMAA_MAX_SEARCH_STEPS_DIAG (diagonal chain search)
_MAX_DIAG = 8


def _luma(rgb: torch.Tensor) -> torch.Tensor:
    return rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722


def _shift(a: torch.Tensor, dy: int, dx: int, fill=0.0) -> torch.Tensor:
    """result[y, x] = a[y + dy, x + dx], ``fill`` outside (no wrap)."""
    h, w = a.shape[:2]
    out = torch.full_like(a, fill)
    y0, y1 = max(0, -dy), min(h, h - dy)
    x0, x1 = max(0, -dx), min(w, w - dx)
    if y1 > y0 and x1 > x0:
        out[y0:y1, x0:x1] = a[y0 + dy:y1 + dy, x0 + dx:x1 + dx]
    return out


def _detect_edges(luma: torch.Tensor):
    """(edge_h, edge_v): edge_h[y, x] between (y, x) and (y - 1, x),
    edge_v[y, x] between (y, x) and (y, x - 1)
    (``SMAALumaEdgeDetectionPS``)."""
    l_up = _shift(luma, -1, 0)
    l_left = _shift(luma, 0, -1)
    d_up = (luma - l_up).abs()
    d_left = (luma - l_left).abs()
    e_h = d_up >= _THRESHOLD
    e_v = d_left >= _THRESHOLD
    # local contrast adaptation: drop edges much weaker than the strongest
    # neighbouring delta
    d_down = (luma - _shift(luma, 1, 0)).abs()
    d_right = (luma - _shift(luma, 0, 1)).abs()
    d_upup = (l_up - _shift(luma, -2, 0)).abs()
    d_leftleft = (l_left - _shift(luma, 0, -2)).abs()
    max_d = torch.maximum(torch.maximum(d_up, d_left), torch.maximum(d_down, d_right))
    max_d = torch.maximum(max_d, torch.maximum(d_upup, d_leftleft))
    e_h = e_h & (_CONTRAST_FACTOR * d_up >= max_d)
    e_v = e_v & (_CONTRAST_FACTOR * d_left >= max_d)
    # the first row and column have no neighbour
    e_h[0, :] = False
    e_v[:, 0] = False
    return e_h, e_v


def _run_extents(e: torch.Tensor, axis: int):
    """For each pixel of ``e``: int32 distances to the start (exclusive of
    itself) and the end of its run along ``axis``, clamped to
    ``_MAX_SEARCH``."""
    n = e.shape[axis]
    shape = [1, 1]
    shape[axis] = n
    idx = torch.arange(n, dtype=torch.int32, device=e.device).reshape(shape).expand(e.shape)
    first = (slice(0, 1), slice(None)) if axis == 0 else (slice(None), slice(0, 1))
    last = (slice(n - 1, n), slice(None)) if axis == 0 else (slice(None), slice(n - 1, n))

    prev = torch.roll(e, 1, axis)
    prev[first] = False
    run_start = torch.where(e & ~prev, idx, -1)
    start = torch.cummax(run_start, dim=axis).values
    d1 = torch.clamp(idx - start, max=_MAX_SEARCH)

    nxt = torch.roll(e, -1, axis)
    nxt[last] = False
    run_end = torch.where(e & ~nxt, idx, 1 << 20)
    # a reversed cummin: the nearest run end at or after each position
    end = -torch.cummax(torch.flip(-run_end, [axis]), dim=axis).values
    d2 = torch.clamp(torch.flip(end, [axis]) - idx, max=_MAX_SEARCH)
    return d1, d2


def _pos_neg_integral(y1, y2):
    """Exact integrals of max(y, 0) and max(-y, 0) over the linear segment
    y1 -> y2 on a unit interval."""
    same = y1 * y2 >= 0.0
    trap = (y1 + y2) * 0.5
    pos_trap = torch.clamp(trap, min=0.0)
    neg_trap = torch.clamp(-trap, min=0.0)
    # a crossing splits at t = y1 / (y1 - y2)
    t = y1 / torch.where((y1 - y2).abs() > 1e-12, y1 - y2, 1e-12)
    tri1 = y1.abs() * t * 0.5
    tri2 = y2.abs() * (1.0 - t) * 0.5
    pos_cross = torch.where(y1 > 0.0, tri1, tri2)
    neg_cross = torch.where(y1 > 0.0, tri2, tri1)
    return (torch.where(same, pos_trap, pos_cross),
            torch.where(same, neg_trap, neg_cross))


def _coverage_areas(d1, d2, h_l, h_r):
    """Coverage of the pixel column [d1, d1 + 1] by the revectorized line
    of a run with extents ``d1``, ``d2`` and end heights ``h_l``, ``h_r``
    (0 or +-0.5): (area on the +y side, area on the pixel's side). One
    height non-zero (L): (0, h_l) -> (d/2, 0), flat beyond; same signs
    (U): the tent (0, h_l) -> (d/2, 0) -> (d, h_r); opposite signs (Z):
    the line (0, h_l) -> (d, h_r)."""
    d1f = d1.to(torch.float32)
    d2f = d2.to(torch.float32)
    d = d1f + d2f + 1.0
    x1 = d1f
    x2 = d1f + 1.0
    m = d * 0.5
    z_pattern = (h_l * h_r) < 0.0

    def tent_y(x):
        y_left = h_l * (1.0 - x / torch.clamp(m, min=1e-6))
        y_right = h_r * (x - m) / torch.clamp(d - m, min=1e-6)
        return torch.where(x <= m, y_left, y_right)

    def line_y(x):
        return h_l + (h_r - h_l) * x / torch.clamp(d, min=1e-6)

    # the column split at the tent's kink where it falls inside
    xm = torch.minimum(torch.maximum(m, x1), x2)
    w_a = xm - x1
    w_b = x2 - xm
    ya1 = torch.where(z_pattern, line_y(x1), tent_y(x1))
    yam = torch.where(z_pattern, line_y(xm), tent_y(xm))
    yb2 = torch.where(z_pattern, line_y(x2), tent_y(x2))
    pa, na = _pos_neg_integral(ya1, yam)
    pb, nb = _pos_neg_integral(yam, yb2)
    return pa * w_a + pb * w_b, na * w_a + nb * w_b


def _crossing_heights(e_cross, e_cross_up, d1, d2, axis: int):
    """Line heights at a run's two ends from the crossing edges there:
    ``e_cross`` on the pixel's row (column for ``axis`` 0), ``e_cross_up``
    on the +y neighbour's; ends clamped by the search see none."""
    h, w = e_cross.shape

    def at_offset(a, off):
        """a[y, x + off] (rows for axis 0), clamped to the frame."""
        if axis == 1:
            base = torch.arange(w, dtype=torch.int32, device=a.device)[None, :]
            return torch.gather(a, 1, torch.clamp(base + off, 0, w - 1).long())
        base = torch.arange(h, dtype=torch.int32, device=a.device)[:, None]
        return torch.gather(a, 0, torch.clamp(base + off, 0, h - 1).long())

    # the left/up end's crossing sits at the run's first pixel, the
    # right/down end's just past its last
    cl_cur, cl_up = at_offset(e_cross, -d1), at_offset(e_cross_up, -d1)
    cr_cur, cr_up = at_offset(e_cross, d2 + 1), at_offset(e_cross_up, d2 + 1)

    def height(clamped, up, cur):
        return torch.where(clamped, 0.0, torch.where(
            up & ~cur, 0.5, torch.where(cur & ~up, -0.5, 0.0)))

    return (height(d1 >= _MAX_SEARCH, cl_up, cl_cur),
            height(d2 >= _MAX_SEARCH, cr_up, cr_cur))


def _diag_weights(e_h: torch.Tensor, e_v: torch.Tensor):
    """Diagonal-pattern weights: a step unit pairs an h-edge with the
    adjacent v-edge, ``U1 = e_h & e_v(x + 1)`` chaining along (+1, +1) and
    ``U2 = e_h & e_v`` along (+1, -1); chains of two units or more are
    revectorized to the 45-degree midline through the staircase corners,
    each unit spreading 0.25-coverage blends onto the four pixels its
    corner touches. Returns (w_up, w_down, w_left, w_right, consumed_h,
    consumed_v), the consumed edges skipping the orthogonal pass."""

    def chain_len(u, dx):
        before = torch.zeros_like(u, dtype=torch.int32)
        after = torch.zeros_like(u, dtype=torch.int32)
        mb = u
        ma = u
        for k in range(1, _MAX_DIAG + 1):
            mb = mb & _shift(u, -k, -k * dx, fill=False)
            ma = ma & _shift(u, k, k * dx, fill=False)
            before = before + mb
            after = after + ma
        return before + 1 + after

    u1 = e_h & _shift(e_v, 0, 1, fill=False)
    u1 = u1 & (chain_len(u1, 1) >= 2)
    u2 = e_h & e_v
    u2 = u2 & (chain_len(u2, -1) >= 2)

    # a 45-degree line half a pixel from a pixel's diagonal covers
    # (2 - sqrt(2)) / 4 of it
    w = 0.14644661
    w1 = torch.where(u1, w, 0.0)
    w2 = torch.where(u2, w, 0.0)
    w_up = w1 + w2
    w_down = _shift(w1, 1, 0) + _shift(w2, 1, 0)
    w_left = _shift(w1, 0, -1) + w2
    w_right = w1 + _shift(w2, 0, 1)
    consumed_h = u1 | u2
    consumed_v = _shift(u1, 0, -1, fill=False) | u2
    return (torch.clamp(w_up, max=0.5), torch.clamp(w_down, max=0.5),
            torch.clamp(w_left, max=0.5), torch.clamp(w_right, max=0.5),
            consumed_h, consumed_v)


def smaa(color: torch.Tensor) -> torch.Tensor:
    """SMAA 1x on an (H, W, 3) image (the LDR frame, after tone
    mapping as in the reference demo)."""
    e_h, e_v = _detect_edges(_luma(color))

    # diagonal patterns first; the edges they own skip the orthogonal pass
    dw_up, dw_down, dw_left, dw_right, consumed_h, consumed_v = _diag_weights(e_h, e_v)
    e_h = e_h & ~consumed_h
    e_v = e_v & ~consumed_v

    # horizontal boundaries: crossings are the vertical edges on this row
    # and the row above
    d1, d2 = _run_extents(e_h, axis=1)
    h_l, h_r = _crossing_heights(e_v, _shift(e_v, -1, 0, fill=False), d1, d2, axis=1)
    a_pos_h, a_neg_h = _coverage_areas(d1, d2, h_l, h_r)
    w_up = torch.where(e_h, a_neg_h, 0.0)                  # this pixel <- up
    w_down = _shift(torch.where(e_h, a_pos_h, 0.0), 1, 0)  # the pixel above

    # vertical boundaries
    d1v, d2v = _run_extents(e_v, axis=0)
    v_l, v_r = _crossing_heights(e_h, _shift(e_h, 0, -1, fill=False), d1v, d2v, axis=0)
    a_pos_v, a_neg_v = _coverage_areas(d1v, d2v, v_l, v_r)
    w_left = torch.where(e_v, a_neg_v, 0.0)                   # this pixel <- left
    w_right = _shift(torch.where(e_v, a_pos_v, 0.0), 0, 1)    # the pixel to the left

    w_up = torch.maximum(w_up, dw_up)
    w_down = torch.maximum(w_down, dw_down)
    w_left = torch.maximum(w_left, dw_left)
    w_right = torch.maximum(w_right, dw_right)

    # neighbourhood blending: each direction fetches mix(centre,
    # neighbour, w), the dominant axis wins, its two weights normalised
    horiz = torch.maximum(w_left, w_right) > torch.maximum(w_up, w_down)
    w1 = torch.where(horiz, w_left, w_up)
    w2 = torch.where(horiz, w_right, w_down)
    n1 = torch.where(horiz[..., None], _shift(color, 0, -1), _shift(color, -1, 0))
    n2 = torch.where(horiz[..., None], _shift(color, 0, 1), _shift(color, 1, 0))
    s = w1 + w2
    any_w = s > 1e-6
    safe_s = torch.where(any_w, s, 1.0)
    u1 = torch.where(any_w, w1 / safe_s, 0.0)
    u2 = torch.where(any_w, w2 / safe_s, 0.0)
    f1 = color * (1.0 - w1[..., None]) + n1 * w1[..., None]
    f2 = color * (1.0 - w2[..., None]) + n2 * w2[..., None]
    blended = f1 * u1[..., None] + f2 * u2[..., None]
    return torch.where(any_w[..., None], blended, color)


class SMAAEffect(Effect):
    """SMAA 1x stage (the reference demo's SMAA branch of its AA switch)."""

    name = "smaa"

    def apply(self, ctx, color, state):
        return smaa(color), state
