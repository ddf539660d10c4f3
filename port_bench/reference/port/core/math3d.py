"""Core 3D math: view/screen/world transforms on torch tensors.

Conventions (the same as the JAX package's ``core/math3d.py``):

- Matrices are host ``(4, 4)`` float32 numpy arrays applied as
  ``M @ [x, y, z, 1]``. Each entry enters the tensor arithmetic as a
  scalar, so a transform needs no host-to-device copy.
- ``view_matrix`` maps world -> view (camera looks down -Z);
  ``camera_matrix_world`` is its inverse.
- Screen ``uv`` is in [0, 1]^2 with ``u`` along width; storage is
  ``(H, W, ...)`` with row 0 at ``v = 0``.
- ``depth`` is the [0, 1] depth-buffer value (NDC z * 0.5 + 0.5).
"""

from __future__ import annotations

import numpy as np
import torch


def _apply_rows(m, p, rows, translate_col):
    """sum_j m[row, j] * p[..., j] (+ m[row, tcol]) for each row.

    Explicit per-row arithmetic, not a matmul: every product and sum is
    one float32 rounding in a fixed order, on the CPU and on the card
    alike (a matmul could reorder the sum or run in TF32)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    outs = []
    for r in rows:
        v = float(m[r, 0]) * x + float(m[r, 1]) * y + float(m[r, 2]) * z
        if translate_col is not None:
            v = v + float(m[r, translate_col])
        outs.append(v)
    return outs


def transform_point(m, p):
    """Apply a 4x4 matrix to points ``(..., 3)`` with w-divide."""
    rx, ry, rz, w = _apply_rows(m, p, (0, 1, 2, 3), 3)
    return torch.stack([rx, ry, rz], dim=-1) / w[..., None]


def transform_point_nodiv(m, p):
    """Apply a 4x4 matrix to points ``(..., 3)``; returns xyz and w."""
    rx, ry, rz, w = _apply_rows(m, p, (0, 1, 2, 3), 3)
    return torch.stack([rx, ry, rz], dim=-1), w


def transform_dir_transpose(m, d):
    """Rotate directions by the *transpose* of the upper 3x3 of ``m``
    (GLSL ``(vec4(d, 0.) * M).xyz``, the inverse rotation of a rigid
    matrix, `ssgi.frag:136`)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return torch.stack(
        [float(m[0, c]) * x + float(m[1, c]) * y + float(m[2, c]) * z
         for c in range(3)], dim=-1)


def luminance(rgb):
    """Rec.709-ish luminance of the reference shaders
    (`reproject.frag:9`, `ssgi_utils.frag:3`)."""
    return rgb[..., 0] * 0.2125 + rgb[..., 1] * 0.7154 + rgb[..., 2] * 0.0721


def view_to_screen(view_pos, projection_matrix):
    """View-space position -> screen uv in [0, 1]^2
    (`ssgi_utils.frag:26-33`)."""
    xyz, w = transform_point_nodiv(projection_matrix, view_pos)
    return xyz[..., :2] / w[..., None] * 0.5 + 0.5


def get_view_position(uv, view_z, projection_matrix, projection_matrix_inverse):
    """View-space position from (uv, viewZ) (``getViewPosition``,
    `ssgi_utils.frag:17-24`): the clip position at the depth implied by
    viewZ through the projection's w row; z is viewZ itself."""
    p, m = projection_matrix, projection_matrix_inverse
    clip_w = float(p[3, 2]) * view_z + float(p[3, 3])
    cx = (uv[..., 0] - 0.5) * 2.0 * clip_w
    cy = (uv[..., 1] - 0.5) * 2.0 * clip_w
    cz = (view_z - 0.5) * 2.0 * clip_w
    rows = [float(m[r, 0]) * cx + float(m[r, 1]) * cy + float(m[r, 2]) * cz
            + float(m[r, 3]) * clip_w for r in (0, 1)]
    return torch.stack([rows[0], rows[1], view_z], dim=-1)


def reflect(i, n):
    """GLSL reflect: i - 2 * dot(n, i) * n."""
    return i - 2.0 * dot(n, i)[..., None] * n


def length(v):
    """Euclidean norm over the last axis, summed in index order."""
    acc = v[..., 0] * v[..., 0]
    for i in range(1, v.shape[-1]):
        acc = acc + v[..., i] * v[..., i]
    return torch.sqrt(acc)


def normalize(v, eps: float = 1e-20):
    return v * torch.reciprocal(torch.clamp(length(v), min=eps))[..., None]


def dot(a, b):
    prod = a * b
    acc = prod[..., 0]
    for i in range(1, prod.shape[-1]):
        acc = acc + prod[..., i]
    return acc


def perspective_depth_to_view_z(depth, near, far):
    """[0,1] depth-buffer value -> (negative) view-space z (three.js
    ``perspectiveDepthToViewZ``). ``near``/``far`` are float32 values;
    the scalar products round in float32 as on the device."""
    nf = float(np.float32(near) * np.float32(far))
    fmn = float(np.float32(far) - np.float32(near))
    return rdiv(nf, fmn * depth - float(far))


def orthographic_depth_to_view_z(depth, near, far):
    return depth * float(np.float32(near) - np.float32(far)) - float(near)


def depth_to_view_z(depth, cam):
    """Depth-buffer value -> view-space z; the projection type is read off
    the projection matrix (``P[3, 2] == -1`` for a perspective camera)."""
    if float(cam.projection_matrix[3, 2]) != 0.0:
        return perspective_depth_to_view_z(depth, cam.near, cam.far)
    return orthographic_depth_to_view_z(depth, cam.near, cam.far)


def screen_to_world(uv, depth, camera_matrix_world, projection_matrix_inverse):
    """(uv, depth) -> world position (`reproject.frag:21-28`)."""
    ndc = torch.stack(
        [(uv[..., 0] - 0.5) * 2.0, (uv[..., 1] - 0.5) * 2.0,
         (depth - 0.5) * 2.0],
        dim=-1,
    )
    clip = transform_point(projection_matrix_inverse, ndc)
    return transform_point(camera_matrix_world, clip)


def fwidth(v, row_offset: int = 0, frame_height: int | None = None):
    """Per-pixel |ddx| + |ddy| over an ``(H, W, ...)`` tensor: forward
    differences, zero at the last column and row (edge replication).

    A row block of a larger frame passes its first row's global index
    ``row_offset`` and the frame's height: the difference is then zero
    at the frame's last row wherever that falls in the block (a row past
    it has no successor in the frame)."""
    dx = torch.zeros_like(v)
    dy = torch.zeros_like(v)
    dx[:, :-1] = v[:, 1:] - v[:, :-1]
    dy[:-1] = v[1:] - v[:-1]
    if frame_height is not None:
        dy[max(0, int(frame_height) - 1 - int(row_offset)):] = 0.0
    return dx.abs() + dy.abs()


def uv_grid(height: int, width: int, device=None, row_offset: int = 0,
            frame_height: int | None = None):
    """Pixel-center uv coordinates, shape ``(H, W, 2)``; row 0 is v=0.

    A row block of a larger frame passes its first row's global index
    ``row_offset`` and the frame's height: v is then the frame's own."""
    fh = height if frame_height is None else int(frame_height)
    u = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) / width
    v = torch.arange(height, dtype=torch.float32, device=device)
    if row_offset:
        v = v + float(row_offset)
    v = (v + 0.5) / fh
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    return torch.stack([uu, vv], dim=-1)


def smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def mix(a, b, t):
    return a + (b - a) * t


def rdiv(num: float, t):
    """``num / t`` as one float32 division. (``float / tensor`` in torch
    is ``t.reciprocal() * num``: two roundings.)"""
    return torch.full_like(t, num) / t


def fma(a, b, c):
    """``a * b + c`` of float32 tensors with the sum rounded once, as the
    fused multiply-adds of XLA's CPU dot (its einsum over a short axis is
    the chain ``fma(a2, b2, fma(a1, b1, a0 * b0))``). The product of two
    float32 is exact in float64, so this rounds to float64 and then to
    float32: it differs from a true fused multiply-add only where the
    float64 sum falls on a float32 halfway point."""
    return (a.double() * b.double() + c.double()).float()


def floor_int32(x):
    """``floor(x)`` as int32 with XLA's conversion law: NaN -> 0 and
    out-of-range values saturate. Bounded here to +-2^30, which every
    caller clips further (to the frame or to +-2^20)."""
    lim = float(1 << 30)
    x = torch.nan_to_num(torch.floor(x), nan=0.0, posinf=lim, neginf=-lim)
    return torch.clamp(x, -lim, lim).to(torch.int32)
