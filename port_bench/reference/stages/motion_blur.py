"""Motion blur, sweep mode: the line integral of upstream's
`motion_blur.frag` (the colour averaged over the pixel's segment
``uv + (jitter * vel * noise +- vel / 2) * frameSpeed``, frameSpeed =
(1/100) / dt) discretised as the JAX package's ``motion_blur_sweep``
defines it: the segment's direction snapped to one of 16 bins rotated
by the frame's R2 offset, a ladder of 12 geometric radii from 0.75 px to
a quarter of the diagonal, each (bin, radius) cell read at its rounded
offset from the float16 colour and weighted by its overlap with the
pixel's own extent on that side; off-frame reads drop out, and the
pixel's own colour weighs the uncovered sliver plus 2/18 of the extent.
Written here as a per-pixel sum over the 192 cells."""

from __future__ import annotations

import math

import numpy as np
import torch

from .common import blue_noise, half

DIRS, STEPS = 16, 12
MIN_R, MAX_FRAC = 0.75, 0.25
R2_PHI = 0.6180339887498949


def _ladder(h: int, w: int, frame: int):
    """float32 (xi, nodes, lower edges, upper edges, dy, dx) of the cells."""
    f32 = np.float32
    diag = f32((h * h + w * w) ** 0.5)
    r_max = f32(MAX_FRAC) * diag
    ks = np.arange(STEPS, dtype=f32)
    nodes = (f32(MIN_R) * (r_max / f32(MIN_R)) ** (ks / f32(STEPS - 1))).astype(f32)
    mid = np.sqrt(nodes[:-1] * nodes[1:]).astype(f32)
    lo = np.concatenate([[f32(0)], mid]).astype(f32)
    hi = np.concatenate([mid, nodes[-1:]]).astype(f32)
    xi = f32(np.mod(f32(frame) * f32(R2_PHI), f32(1.0)))
    bin_w = f32(2.0 * math.pi / DIRS)
    ang = ((np.arange(DIRS, dtype=f32) + xi) * bin_w).astype(f32)
    dx = np.round(nodes[None, :] * np.cos(ang)[:, None]).astype(np.int64)
    dy = np.round(nodes[None, :] * np.sin(ang)[:, None]).astype(np.int64)
    return xi, bin_w, lo, hi, dy, dx


def step(rec):
    ctx, color = rec["ctx"], rec["color"]
    u = ctx.params["motion_blur"]
    vel0 = ctx.velocity.velocity
    h, w = color.shape[:2]
    dev = color.device
    vel = vel0 * u["intensity"]
    moved = (vel0 * vel0).sum(-1) > 1e-9
    speed = (1.0 / 100.0) / u["delta_time"]
    seg = vel * speed * torch.tensor([float(w), float(h)], device=dev)
    length = torch.linalg.vector_norm(seg, dim=-1)
    half_len = 0.5 * length
    theta = torch.atan2(seg[..., 1], seg[..., 0])
    j = u["jitter"] * blue_noise(h, w, ctx.frame_index, dev)[..., 0] * length
    u_pos = torch.clamp(j + half_len, min=0.0)
    u_neg = torch.clamp(half_len - j, min=0.0)
    xi, bin_w, lo, hi, dy, dx = _ladder(h, w, ctx.frame_index)
    xi, bin_w = float(xi), float(bin_w)
    b_pos = torch.remainder(torch.round(theta / bin_w - xi), float(DIRS))
    b_neg = torch.remainder(torch.round((theta + math.pi) / bin_w - xi), float(DIRS))
    src = half(color)
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    acc = torch.zeros_like(color)
    wsum = torch.zeros_like(length)
    for d in range(DIRS):
        on_pos = (b_pos == d).float()
        on_neg = (b_neg == d).float()
        for k in range(STEPS):
            oy, ox = int(dy[d, k]), int(dx[d, k])
            wk = (torch.clamp(torch.minimum(u_pos, torch.tensor(float(hi[k]), device=dev))
                              - float(lo[k]), min=0.0) * on_pos
                  + torch.clamp(torch.minimum(u_neg, torch.tensor(float(hi[k]), device=dev))
                                - float(lo[k]), min=0.0) * on_neg)
            ty, tx = ys + oy, xs + ox
            inside = ((ty >= 0) & (ty < h) & (tx >= 0) & (tx < w)).float()
            wk = wk * inside
            acc = acc + src[ty.clamp(0, h - 1).expand(h, w), tx.clamp(0, w - 1).expand(h, w)] \
                * wk[..., None]
            wsum = wsum + wk
    edge = float(hi[-1])
    covered = torch.clamp(u_pos, max=edge) + torch.clamp(u_neg, max=edge)
    w_c = torch.clamp(u_pos + u_neg - covered, min=0.0) + (u_pos + u_neg) * (2.0 / 18.0) + 1e-6
    blurred = (acc + color * w_c[..., None]) / (wsum + w_c)[..., None]
    return torch.where(moved[..., None], blurred, color), rec["state"]
