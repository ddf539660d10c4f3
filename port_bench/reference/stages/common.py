"""Per-pixel helpers of the stage references (``reference/stages``).

Each follows the definition it cites; none is shared with the frozen
copy or the program. Images are (H, W[, C]) float32 tensors; camera
matrices are float32 host arrays, applied row by row as the shaders'
mat4 products are.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

TILE = Path(__file__).resolve().parent.parent / "assets" / "blue_noise_128x128x4.npy"
PI = math.pi


def uv_grid(h: int, w: int, dev) -> torch.Tensor:
    """Pixel-centre uv (H, W, 2); row 0 is v = 0."""
    u = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    v = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    return torch.stack([u[None, :].expand(h, w), v[:, None].expand(h, w)], -1)


def _rows(m, p):
    m = np.asarray(m, np.float32)
    x, y, z = p.unbind(-1)
    return [float(m[r, 0]) * x + float(m[r, 1]) * y + float(m[r, 2]) * z + float(m[r, 3])
            for r in range(4)]


def project(m, p):
    """(xyz, w) of ``m`` applied to points ``p`` (..., 3) with w = 1."""
    r = _rows(m, p)
    return torch.stack(r[:3], -1), r[3]


def point(m, p):
    """``m`` applied to points ``p`` with the w-divide."""
    xyz, w = project(m, p)
    return xyz / w[..., None]


def rotate_t(m, d):
    """GLSL ``(vec4(d, 0) * M).xyz``: the transposed 3x3 of ``m`` on ``d``."""
    m = np.asarray(m, np.float32)
    x, y, z = d.unbind(-1)
    return torch.stack([float(m[0, c]) * x + float(m[1, c]) * y + float(m[2, c]) * z
                        for c in range(3)], -1)


def proj_view(cam) -> np.ndarray:
    return (np.asarray(cam.projection_matrix, np.float64)
            @ np.asarray(cam.view_matrix, np.float64)).astype(np.float32)


def screen_to_world(uv, depth, cam):
    """`reproject.frag:21-28`: (uv, depth) through the inverse projection
    and the camera's world matrix."""
    ndc = torch.stack([(uv[..., 0] - 0.5) * 2.0, (uv[..., 1] - 0.5) * 2.0,
                       (depth - 0.5) * 2.0], -1)
    return point(cam.camera_matrix_world, point(cam.projection_matrix_inverse, ndc))


def view_z(depth, cam):
    """three.js ``perspectiveDepthToViewZ``."""
    if float(np.asarray(cam.projection_matrix)[3, 2]) == 0.0:
        raise NotImplementedError("an orthographic camera")
    n, f = float(cam.near), float(cam.far)
    return (n * f) / ((f - n) * depth - f)


def dot(a, b):
    return (a * b).sum(-1)


def normalize(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-20)


def mix(a, b, t):
    return a + (b - a) * t


def luminance(rgb):
    return rgb[..., 0] * 0.2125 + rgb[..., 1] * 0.7154 + rgb[..., 2] * 0.0721


def half(x):
    """``x`` stored in a float16 texture and read back."""
    return x.to(torch.float16).to(torch.float32)


def fwidth(v):
    """|ddx| + |ddy| by forward differences, the last row and column
    repeated (the JAX package's stand-in for GLSL ``fwidth``)."""
    dx = torch.cat([v[:, 1:] - v[:, :-1], torch.zeros_like(v[:, :1])], 1).abs()
    dy = torch.cat([v[1:] - v[:-1], torch.zeros_like(v[:1])], 0).abs()
    return dx + dy


def fetch(tex, iy, ix):
    """Texel fetch with the coordinates clamped to the frame."""
    h, w = tex.shape[0], tex.shape[1]
    return tex[iy.clamp(0, h - 1), ix.clamp(0, w - 1)]


def _pcg4d(v):
    """`blue_noise.glsl:17-28` on uint32 (wrapping) arithmetic."""
    with np.errstate(over="ignore"):
        v = v * np.uint32(1664525) + np.uint32(1013904223)
        x, y, z, w = v
        x = x + y * w
        y = y + z * x
        z = z + x * y
        w = w + y * z
        v = np.stack([x, y, z, w])
        v = v ^ (v >> np.uint32(16))
        x, y, z, w = v
        x = x + y * w
        y = y + z * x
        z = z + x * y
        w = w + y * z
    return np.stack([x, y, z, w])


def noise_shift(index: int) -> tuple[int, int]:
    """(sx, sy): the tile offset of frame ``index`` (`blue_noise.glsl:37-48`):
    PCG4D of (i, 15843 i, 31 i + 4566, 2345 i + 58585), its first two
    words modulo 0x0FFFFFFF, then modulo the tile."""
    i = np.array([int(index) % 2 ** 32], np.uint64).astype(np.uint32)
    with np.errstate(over="ignore"):
        seed = np.stack([i, i * np.uint32(15843), i * np.uint32(31) + np.uint32(4566),
                         i * np.uint32(2345) + np.uint32(58585)])
    s = _pcg4d(seed)[:, 0] % np.uint32(0x0FFFFFFF)
    return int(s[0]) % 128, int(s[1]) % 128


def blue_noise(h: int, w: int, index: int, dev) -> torch.Tensor:
    """(H, W, 4): pixel (x, y) reads the 128 x 128 tile at ((x + sx) % 128,
    (y + sy) % 128) for frame ``index``'s shift."""
    sx, sy = noise_shift(index)
    tile = torch.as_tensor(np.load(TILE), device=dev)
    ys = (torch.arange(h, device=dev) + sy) % 128
    xs = (torch.arange(w, device=dev) + sx) % 128
    return tile[ys[:, None], xs[None, :]]


def window_rows_cols(iy, ix, h: int, w: int, ky: int, kx: int, reach: int = 0):
    """The frame-then-window clamp of a fetch at integer target (iy, ix):
    (row of band 0, the in-window flag, a function from a tap's column
    offset to its column). A band ``b`` rows off reads
    ``ys + clip(clip(clip(iy - ys, -ky, ky) + b, -ys, h - 1 - ys), -ky - reach_lo, ky + reach_hi)``;
    see :func:`band_row`. The flag is |iy - ys| <= ky and |ix - xs| <= kx."""
    dev = iy.device
    ys = torch.arange(h, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, device=dev)[None, :].expand(h, w)
    dy, dx = iy - ys, ix - xs
    ok = (dy.abs() <= ky) & (dx.abs() <= kx)
    kxw = kx + reach
    col = lambda k: xs + torch.clamp(torch.clamp(ix + k, 0, w - 1) - xs, -kxw, kxw)
    return ys, torch.clamp(dy, -ky, ky), ok, col


def band_row(ys, dyc, b: int, h: int, ky: int, lo: int, hi: int):
    """Row of band ``b`` (see :func:`window_rows_cols`); ``lo`` and ``hi`` are
    the least and greatest band offsets of the filter."""
    r = torch.minimum(torch.maximum(dyc + b, -ys), (h - 1) - ys)
    return ys + torch.clamp(r, -ky + lo, ky + hi)


def to_index(x):
    """floor(x) as int64, the float clipped to +-2^20 first."""
    return torch.floor(torch.clamp(x, -2.0 ** 20, 2.0 ** 20)).to(torch.int64)


def nearest_window(tex, uv, ky: int, kx: int):
    """Nearest fetch at ``uv`` within a +-ky x +-kx window: (value, flag)."""
    h, w = tex.shape[0], tex.shape[1]
    iy, ix = to_index(uv[..., 1] * h), to_index(uv[..., 0] * w)
    ys, dyc, ok, col = window_rows_cols(iy, ix, h, w, ky, kx)
    return tex[band_row(ys, dyc, 0, h, ky, 0, 0), col(0)], ok


def catmull_rom_weights(f):
    f2 = f * f
    f3 = f2 * f
    w0 = f2 - 0.5 * (f3 + f)
    w1 = 1.5 * f3 - 2.5 * f2 + 1.0
    w3 = 0.5 * (f3 - f2)
    return w0, w1, 1.0 - w0 - w1 - w3, w3


def catmull_rom5_window(tex, uv, ky: int, kx: int):
    """`reproject.frag:212-255`'s 5-tap Catmull-Rom of a float16 texture:
    the 4 x 4 footprint with its corner texels dropped, normalised by the
    weight left, clamped at 0, each texel fetched with the window clamp
    of :func:`window_rows_cols` (reach 2)."""
    tex = half(tex)
    h, w = tex.shape[0], tex.shape[1]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    ys, dyc, _, col = window_rows_cols(to_index(y0), to_index(x0), h, w, ky, kx, reach=2)
    wx, wy = catmull_rom_weights(fx), catmull_rom_weights(fy)
    out = 0.0
    for b, bo in enumerate((-1, 0, 1, 2)):
        rows = band_row(ys, dyc, bo, h, ky, -1, 2)
        row = 0.0
        for k, ko in enumerate((-1, 0, 1, 2)):
            if b in (0, 3) and k in (0, 3):
                continue
            row = row + tex[rows, col(ko)] * wx[k][..., None]
        out = out + row * wy[b][..., None]
    total = 1.0 - (wx[0] + wx[3]) * (wy[0] + wy[3])
    return torch.clamp(out / total[..., None], min=0.0)


def encode_oct(n):
    n = n / (n[..., 0:1].abs() + n[..., 1:2].abs() + n[..., 2:3].abs())
    xy = n[..., :2]
    wrapped = (1.0 - xy.flip(-1).abs()) * torch.where(xy >= 0.0, 1.0, -1.0)
    return torch.where(n[..., 2:3] > 0.0, xy, wrapped) * 0.5 + 0.5


def decode_oct(f):
    f = f * 2.0 - 1.0
    z = 1.0 - f[..., 0].abs() - f[..., 1].abs()
    t = torch.clamp(-z, min=0.0)
    x = f[..., 0] + torch.where(f[..., 0] >= 0.0, -t, t)
    y = f[..., 1] + torch.where(f[..., 1] >= 0.0, -t, t)
    return normalize(torch.stack([x, y, z], -1))


def cosine_hemisphere(n, u):
    """`ssgi_utils.frag:183-191`: a cosine-weighted direction about ``n``."""
    r = torch.sqrt(u[..., 0])
    theta = 2.0 * PI * u[..., 1]
    ref = torch.tensor([0.0, 1.0, 1.0], device=n.device).expand_as(n)
    b = normalize(torch.linalg.cross(n, ref))
    t = torch.linalg.cross(b, n)
    return normalize(r[..., None] * torch.sin(theta)[..., None] * b
                     + torch.sqrt(1.0 - u[..., 0])[..., None] * n
                     + r[..., None] * torch.cos(theta)[..., None] * t)


def onb(n):
    """`ssgi_utils.frag:172-176`: (t, b) about ``n``."""
    up = torch.tensor([0.0, 0.0, 1.0], device=n.device).expand_as(n)
    alt = torch.tensor([1.0, 0.0, 0.0], device=n.device).expand_as(n)
    up = torch.where((n[..., 2].abs() < 0.9999999)[..., None], up, alt)
    t = normalize(torch.linalg.cross(up, n))
    return t, torch.linalg.cross(n, t)


def ggx_vndf(v, a, r1, r2):
    """`ssgi_utils.frag:153-170`: a GGX visible-normal half vector about
    z for the local view ``v``, roughness ``a`` and randoms ``r1``, ``r2``."""
    vh = normalize(torch.stack([a * v[..., 0], a * v[..., 1], v[..., 2]], -1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv_len = torch.where(lensq > 0.0, 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-20)), 0.0)
    t1 = torch.stack([-vh[..., 1] * inv_len, vh[..., 0] * inv_len, torch.zeros_like(inv_len)], -1)
    t1 = torch.where((lensq > 0.0)[..., None], t1,
                     torch.tensor([1.0, 0.0, 0.0], device=v.device).expand_as(t1))
    t2 = torch.linalg.cross(vh, t1)
    r = torch.sqrt(r1)
    phi = 2.0 * PI * r2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    nh = (p1[..., None] * t1 + p2[..., None] * t2
          + torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))[..., None] * vh)
    return normalize(torch.stack([a * nh[..., 0], a * nh[..., 1],
                                  torch.clamp(nh[..., 2], min=0.0)], -1))


def bilinear(tex, uv):
    """GL LinearFilter with clamp-to-edge (a sample left of or above the
    first texel centre reads it alone)."""
    h, w = tex.shape[0], tex.shape[1]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx = torch.where(x0 < 0.0, 0.0, x - x0)[..., None]
    fy = torch.where(y0 < 0.0, 0.0, y - y0)[..., None]
    ix, iy = to_index(x0).clamp(0, w - 1), to_index(y0).clamp(0, h - 1)
    ix1, iy1 = (ix + 1).clamp(max=w - 1), (iy + 1).clamp(max=h - 1)
    top = tex[iy, ix] + (tex[iy, ix1] - tex[iy, ix]) * fx
    bot = tex[iy1, ix] + (tex[iy1, ix1] - tex[iy1, ix]) * fx
    return top + (bot - top) * fy


def equirect_uv(d):
    """`ssgi_utils.frag:64-74`: a world direction's equirect uv."""
    u = torch.atan2(d[..., 2], d[..., 0]) / (2.0 * PI) + 0.5
    v = 1.0 - torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0)) / PI
    return torch.stack([u, v], -1)
