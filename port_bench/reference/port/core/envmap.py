"""Equirectangular environment maps: sampling, mips and the importance-
sampling CDF tables (the JAX package's ``core/envmap.py``).

- direction <-> equirect uv (`ssgi_utils.frag:64-92`);
- the luminance inverse-CDF tables the reference builds in a Web Worker
  (`EquirectHdrInfoUniform.js:149-245`): built on the host, by the C++
  library in ``native/`` or by numpy, then copied to the device once;
- the mip atlas for blurred fetches (``envBlur``, `ssgi.frag:322-327`);
- cube maps (``CubeToEquirectEnvPass``), the GGX-prefiltered pyramid and
  ``blur_env`` (the reference demo's ``BlurredEnvMapGenerator``), which
  compute on the device of their tensor argument (a numpy argument goes
  to ``cuda`` unless another device is asked for).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .math3d import luminance
from .sampling import (MipAtlas, build_mip_atlas, build_mip_chain,
                       sample_bilinear, sample_bilinear_mip, sample_mip_atlas)


@dataclasses.dataclass(frozen=True)
class EquirectEnv:
    """The device-side environment: ``mips`` (H, W, 3) float16 levels,
    the same pyramid as one float16 :class:`MipAtlas`, the inverse-CDF
    lookups ``marginal`` (H,) and ``conditional`` (H, W), the luminance
    sum ``total_sum`` (a 0-d tensor) and ``cdf_packed``, the (Hc, Wc, 4)
    float16 table [u, v, lum, 0] that composes the marginal ->
    conditional -> colour chain into one fetch."""

    mips: tuple
    atlas: MipAtlas
    marginal: torch.Tensor
    conditional: torch.Tensor
    total_sum: torch.Tensor
    cdf_packed: torch.Tensor | None = None

    @property
    def map(self) -> torch.Tensor:
        return self.mips[0]

    @property
    def size(self) -> tuple:
        return self.mips[0].shape[0], self.mips[0].shape[1]

    @property
    def max_mip_level(self) -> int:
        return len(self.mips) - 1

    @property
    def device(self) -> torch.device:
        return self.marginal.device


def direction_to_equirect_uv(direction: torch.Tensor) -> torch.Tensor:
    """(..., 3) world direction -> equirect uv (`ssgi_utils.frag:64-74`)."""
    u = torch.atan2(direction[..., 2], direction[..., 0]) / (2.0 * math.pi) + 0.5
    v = 1.0 - torch.acos(torch.clamp(direction[..., 1], -1.0, 1.0)) / math.pi
    return torch.stack([u, v], dim=-1)


def equirect_uv_to_direction(uv: torch.Tensor) -> torch.Tensor:
    """Equirect uv -> (..., 3) world direction (`ssgi_utils.frag:77-86`)."""
    theta = (uv[..., 0] - 0.5) * 2.0 * math.pi
    phi = (1.0 - uv[..., 1]) * math.pi
    sin_phi = torch.sin(phi)
    return torch.stack([sin_phi * torch.cos(theta), torch.cos(phi),
                        sin_phi * torch.sin(theta)], dim=-1)


def sample_equirect_color(env: EquirectEnv, direction: torch.Tensor, lod,
                          quantize: bool = False) -> torch.Tensor:
    """``sampleEquirectEnvMapColor`` (`ssgi_utils.frag:90-92`) from the
    mip atlas; ``quantize`` rounds the lod to the nearest level."""
    uv = direction_to_equirect_uv(direction)
    return sample_mip_atlas(env.atlas, uv, lod, quantize=quantize)


def sample_equirect_probability(env: EquirectEnv, noise2: torch.Tensor,
                                fast: bool = False):
    """Importance-sample the environment (`ssgi_utils.frag:210-225`).
    ``noise2``: (..., 2) uniforms. Returns (pdf, direction), pdf =
    ``width * height * lum / totalSum``. ``fast`` reads the composed
    ``cdf_packed`` table (one fetch, bilinear in the noise) instead of the
    exact marginal -> conditional -> colour chain."""
    h, w = env.size
    if fast and env.cdf_packed is not None:
        t = sample_bilinear(env.cdf_packed,
                            torch.stack([noise2[..., 1], noise2[..., 0]], -1))
        direction = equirect_uv_to_direction(t[..., 0:2])
        pdf = t[..., 2] / env.total_sum
        return (w * h) * pdf, direction
    zero = torch.zeros_like(noise2[..., 0])
    v = sample_bilinear(env.marginal[:, None],
                        torch.stack([zero, noise2[..., 0]], -1))
    u = sample_bilinear(env.conditional, torch.stack([noise2[..., 1], v], -1))
    uv = torch.stack([u, v], dim=-1)
    direction = equirect_uv_to_direction(uv)
    pdf = luminance(sample_bilinear(env.map, uv)) / env.total_sum
    return (w * h) * pdf, direction


# ---------------------------------------------------------------------------
# host-side construction (the reference's Web Worker)
# ---------------------------------------------------------------------------

def _np_bilinear(tex: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Host bilinear with :func:`sample_bilinear`'s clamp-to-edge (x, y
    in texel units, already -0.5)."""
    h, w = tex.shape[:2]
    x0 = np.floor(x)
    y0 = np.floor(y)
    fx = np.where(x0 < 0.0, 0.0, x - x0)
    fy = np.where(y0 < 0.0, 0.0, y - y0)
    xi = np.clip(x0.astype(np.int64), 0, w - 1)
    yi = np.clip(y0.astype(np.int64), 0, h - 1)
    xj = np.clip(xi + 1, 0, w - 1)
    yj = np.clip(yi + 1, 0, h - 1)
    if tex.ndim == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    top = tex[yi, xi] + (tex[yi, xj] - tex[yi, xi]) * fx
    bot = tex[yj, xi] + (tex[yj, xj] - tex[yj, xi]) * fx
    return top + (bot - top) * fy


def _build_cdf_packed(data: np.ndarray, marginal: np.ndarray,
                      conditional: np.ndarray) -> np.ndarray:
    """The inverse-CDF chain evaluated in float64 on a dense noise grid
    (rows: noise.x, the marginal lookup; columns: noise.y, the
    conditional one), [u, v, lum, 0] per cell, stored as float16."""
    h, w = conditional.shape
    hc = int(min(max(4 * h, 64), 1024))
    wc = int(min(max(2 * w, 64), 1024))
    nx = (np.arange(hc, dtype=np.float64) + 0.5) / hc
    ny = (np.arange(wc, dtype=np.float64) + 0.5) / wc
    ym = nx * h - 0.5
    y0m = np.floor(ym)
    fym = np.where(y0m < 0.0, 0.0, ym - y0m)
    yim = np.clip(y0m.astype(np.int64), 0, h - 1)
    yjm = np.clip(yim + 1, 0, h - 1)
    marg = marginal.astype(np.float64)
    v = marg[yim] + (marg[yjm] - marg[yim]) * fym
    vy = np.broadcast_to(v[:, None], (hc, wc)) * h - 0.5
    uxx = np.broadcast_to(ny[None, :], (hc, wc)) * w - 0.5
    u = _np_bilinear(conditional.astype(np.float64), uxx, vy)
    col = _np_bilinear(data.astype(np.float64), u * w - 0.5,
                       np.broadcast_to(v[:, None], (hc, wc)) * h - 0.5)
    lum = 0.2125 * col[..., 0] + 0.7154 * col[..., 1] + 0.0721 * col[..., 2]
    packed = np.stack([u, np.broadcast_to(v[:, None], (hc, wc)), lum,
                       np.zeros_like(u)], axis=-1)
    return packed.astype(np.float16)


def _cdf_numpy(data: np.ndarray):
    """Marginal and conditional inverse CDFs and the luminance total
    (`EquirectHdrInfoUniform.js:149-245`, half-texel centred), in the
    arithmetic of the program's ``native/envcdf.cpp``: the luminance in
    float64 from the float32 channels, every sum running in order."""
    h, w = data.shape[:2]
    d = data.astype(np.float64)
    lum = 0.2125 * d[..., 0] + 0.7154 * d[..., 1] + 0.0721 * d[..., 2]
    cdf_cond = np.cumsum(lum, axis=1)
    row_sums = cdf_cond[:, -1].copy()
    cdf_marg = np.cumsum(row_sums)
    total = float(cdf_marg[-1])
    cdf_cond = cdf_cond / np.where(row_sums != 0.0, row_sums, 1.0)[:, None]
    if total > 0:
        cdf_marg = cdf_marg / total
    rows = np.searchsorted(cdf_marg, (np.arange(h) + 1.0) / h, side="left")
    marginal = ((np.clip(rows, 0, h - 1) + 0.5) / h).astype(np.float32)
    targets_x = (np.arange(w) + 1.0) / w
    cols = np.stack([np.searchsorted(cdf_cond[y], targets_x, side="left")
                     for y in range(h)])
    conditional = ((np.clip(cols, 0, w - 1) + 0.5) / w).astype(np.float32)
    return marginal, conditional, total


def build_equirect_env(data: np.ndarray, max_mip_levels: int | None = None,
                       device=None) -> EquirectEnv:
    """The environment of an (H, W, 3) HDR image on ``device`` (``cuda``
    unless another device is asked for). The image is clipped to the
    float16 range and stored as float16, the reference's HalfFloatType
    textures; the CDFs are built from those same values, by the C++
    library when it builds (``native.available()``), else by numpy."""
    from ..composer import resolve_device

    dev = resolve_device(device)
    data = np.clip(np.asarray(data, np.float32), 0.0, 65504.0)
    data = data.astype(np.float16).astype(np.float32)
    tables = None  # frozen: the numpy tables
    marginal, conditional, total = tables if tables is not None \
        else _cdf_numpy(data)
    base = torch.from_numpy(data)
    atlas = build_mip_atlas(base)
    return EquirectEnv(
        mips=tuple(m.to(torch.float16).to(dev)
                   for m in build_mip_chain(base, max_levels=max_mip_levels)),
        atlas=MipAtlas(atlas.data.to(torch.float16).to(dev), atlas.shapes),
        marginal=torch.from_numpy(np.asarray(marginal)).to(dev),
        conditional=torch.from_numpy(np.asarray(conditional)).to(dev),
        total_sum=torch.tensor(total, dtype=torch.float32, device=dev),
        cdf_packed=torch.from_numpy(_build_cdf_packed(
            data, np.asarray(marginal), np.asarray(conditional))).to(dev),
    )


def _on_device(x, device=None) -> torch.Tensor:
    """A float32 tensor of ``x``: a tensor stays on its device, anything
    else goes to ``resolve_device(device)``."""
    if isinstance(x, torch.Tensor):
        return x.float()
    from ..composer import resolve_device

    return torch.as_tensor(np.asarray(x, np.float32), device=resolve_device(device))


#: (major axis, u axis, v axis) of each cube face, in GL order
_CUBE_AXES = (
    ((1, 0, 0), (0, 0, -1), (0, -1, 0)),   # +x
    ((-1, 0, 0), (0, 0, 1), (0, -1, 0)),   # -x
    ((0, 1, 0), (1, 0, 0), (0, 0, 1)),     # +y
    ((0, -1, 0), (1, 0, 0), (0, 0, -1)),   # -y
    ((0, 0, 1), (1, 0, 0), (0, -1, 0)),    # +z
    ((0, 0, -1), (-1, 0, 0), (0, -1, 0)),  # -z
)


def math3d_dot_const(d, c):
    """``d . c`` of (..., 3) directions and a constant 3-vector."""
    return d[..., 0] * c[0] + d[..., 1] * c[1] + d[..., 2] * c[2]


def _equirect_directions(height: int, width: int, device) -> torch.Tensor:
    """The direction of each texel centre of a (height, width) equirect."""
    v = (torch.arange(height, device=device) + 0.5) / height
    u = (torch.arange(width, device=device) + 0.5) / width
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    return equirect_uv_to_direction(torch.stack([uu, vv], dim=-1))


def cube_to_equirect(faces, height: int, width: int) -> torch.Tensor:
    """A (height, width, 3) equirect from (6, S, S, 3) cube faces
    (``CubeToEquirectEnvPass``, `CubeToEquirectEnvPass.js:59-99`): each
    texel reads the bilinear texel of its direction's major face."""
    faces = _on_device(faces)
    d = _equirect_directions(height, width, faces.device)
    ax, ay, az = d[..., 0].abs(), d[..., 1].abs(), d[..., 2].abs()
    out = torch.zeros((height, width, 3), dtype=faces.dtype, device=faces.device)
    for idx, (fwd, u_ax, v_ax) in enumerate(_CUBE_AXES):
        ma = math3d_dot_const(d, [float(c) for c in fwd])
        if fwd[0] != 0:
            is_major = (ax >= ay) & (ax >= az) & (ma > 0)
        elif fwd[1] != 0:
            is_major = (ay > ax) & (ay >= az) & (ma > 0)
        else:
            is_major = (az > ax) & (az > ay) & (ma > 0)
        safe_ma = torch.where(ma.abs() > 1e-8, ma, 1e-8)
        fu = math3d_dot_const(d, [float(c) for c in u_ax]) / safe_ma
        fv = math3d_dot_const(d, [float(c) for c in v_ax]) / safe_ma
        face_uv = torch.stack([fu, fv], dim=-1) * 0.5 + 0.5
        col = sample_bilinear(faces[idx], face_uv)
        out = torch.where(is_major[..., None], col, out)
    return out


def _ggx_sample_table(roughness: float, samples: int,
                      base_h: int, base_w: int) -> np.ndarray:
    """Tangent-space GGX-NDF importance samples of the split-sum
    prefilter (n = v) over an R2 set, built in float64: (samples, 5)
    float32 rows ``(lx, ly, lz, weight n.l, source lod)``, the lod from
    the sample's solid angle (filtered importance sampling)."""
    a = max(roughness, 1e-3) ** 2
    i = np.arange(samples, dtype=np.float64)
    g = 1.3247179572447460
    xi1 = np.mod((i + 1) / g, 1.0)
    xi2 = np.mod((i + 1) / (g * g), 1.0)
    phi = 2.0 * np.pi * xi1
    cos_t = np.sqrt((1.0 - xi2) / (1.0 + (a * a - 1.0) * xi2))
    sin_t = np.sqrt(np.maximum(1.0 - cos_t * cos_t, 0.0))
    h = np.stack([sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], -1)
    l = 2.0 * h[:, 2:3] * h - np.array([0.0, 0.0, 1.0])
    w = np.maximum(l[:, 2], 0.0)
    d_ggx = a * a / (np.pi * ((a * a - 1.0) * cos_t ** 2 + 1.0) ** 2)
    pdf = np.maximum(d_ggx * cos_t / np.maximum(4.0 * cos_t, 1e-8), 1e-12)
    omega_s = 1.0 / (samples * pdf)
    omega_p = 4.0 * np.pi / (base_h * base_w)
    lod = np.maximum(0.5 * np.log2(omega_s / omega_p), 0.0)
    return np.concatenate([l, w[:, None], lod[:, None]], -1).astype(np.float32)


def _cross(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _ggx_filter_level(box_mips, h: int, w: int, roughness: float,
                      samples: int) -> torch.Tensor:
    """An (h, w, 3) level of the box chain convolved with the GGX lobe of
    ``roughness``: the table's samples in order, summed as they come."""
    dev = box_mips[0].device
    n = _equirect_directions(h, w, dev)
    y_up = torch.tensor([0.0, 1.0, 0.0], device=dev)
    x_up = torch.tensor([1.0, 0.0, 0.0], device=dev)
    up = torch.where(n[..., 1:2].abs() < 0.999, y_up, x_up)
    t = _cross(up, n)
    t = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-8)
    b = _cross(n, t)
    base_h, base_w = box_mips[0].shape[:2]
    table = torch.as_tensor(_ggx_sample_table(roughness, samples, base_h, base_w),
                            device=dev)
    acc = torch.zeros((h, w, 3), dtype=box_mips[0].dtype, device=dev)
    wsum = torch.zeros((), device=dev)
    for row in table:
        l = row[0] * t + row[1] * b + row[2] * n
        col = sample_bilinear_mip(box_mips, direction_to_equirect_uv(l), row[4])
        acc = acc + col * row[3]
        wsum = wsum + row[3]
    return acc / torch.clamp(wsum, min=1e-8)


def ggx_prefilter_mips(equirect, max_levels: int | None = None,
                       samples: int = 96) -> tuple:
    """The roughness-indexed GGX-prefiltered equirect pyramid (three.js
    ``PMREMGenerator`` as the reference demo uses it,
    `BlurredEnvMapGenerator.js:310-358`): level 0 is the map, level L the
    box mip of its size convolved with the GGX lobe of roughness
    L / (levels - 1)."""
    box = build_mip_chain(_on_device(equirect), max_levels=max_levels)
    n_levels = len(box)
    out = [box[0]]
    for lvl in range(1, n_levels):
        h, w = box[lvl].shape[:2]
        out.append(_ggx_filter_level(box, h, w, lvl / (n_levels - 1), samples))
    return tuple(out)


#: directions of blur_env's scatter set (the copy shader's ``mix(dir,
#: randomDir, blur)``, `BlurredEnvMapGenerator.js:253-261`, an R3 set)
_BLUR_SCATTER_SAMPLES = 32


def blur_env(equirect, blur: float, samples: int = 96) -> torch.Tensor:
    """An (H, W, 3) equirect blurred by ``blur`` in [0, 1]
    (``BlurredEnvMapGenerator.generate``): the mean over the scatter set
    of the GGX pyramid fetched at ``mix(dir, scatter, blur)``, lod
    ``blur * (levels - 1)``. ``blur <= 0`` returns the map as it is."""
    blur = float(blur)
    if blur <= 0.0:
        return equirect
    equirect = _on_device(equirect)
    mips = ggx_prefilter_mips(equirect, samples=samples)
    h, w = equirect.shape[0], equirect.shape[1]
    d = _equirect_directions(h, w, equirect.device)
    lod = float(np.float32(blur) * np.float32(len(mips) - 1))
    i = np.arange(_BLUR_SCATTER_SAMPLES, dtype=np.float64) + 1.0
    g = 1.2207440846057596
    r = np.stack([np.mod(i / g, 1.0), np.mod(i / g ** 2, 1.0),
                  np.mod(i / g ** 3, 1.0)], -1) * 2.0 - 1.0
    r /= np.maximum(np.linalg.norm(r, axis=-1, keepdims=True), 1e-8)
    acc = torch.zeros_like(equirect)
    for rd in torch.as_tensor(r.astype(np.float32), device=equirect.device):
        md = d * (1.0 - blur) + rd * blur
        md = md / torch.clamp(torch.linalg.vector_norm(md, dim=-1, keepdim=True),
                              min=1e-8)
        acc = acc + sample_bilinear_mip(mips, direction_to_equirect_uv(md), lod)
    return acc / _BLUR_SCATTER_SAMPLES


