"""Direction-binned sweep ray tracing: the SSGI trace of the JAX package's
``ops/ssgi_sweep.py``.

The same re-discretisation of the reference's screen-space march
(`ssgi.frag:441-503`): a ray projects to a screen line along which 1/w
is linear, so its view z at screen distance s is closed form; rays are
binned by screen direction into ``dirs`` sectors, rotated each frame by
an R2 angle, and every bin walks the same texel offsets at a shared
geometric schedule of ``steps`` radii; the hit is refined analytically
from the hit texel's depth. Out-of-frame samples are misses.

The march itself is the sweep kernel (``ops/sweep_kernel.py``). Here:
the per-pixel ray projection, the bin choice, the step table, and after
the march the refine, the miss uv and the hit position.

The frame index is a host int, so the step table is built on the host.
It is the JAX package's table bit for bit: float32 arithmetic in the
same order, with ``cosf``, ``sinf`` and ``powf`` from the C library,
which is what XLA's CPU backend calls for them.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math

import numpy as np
import torch

from ..core import math3d
from .sweep_kernel import sweep_march

EPS = 1e-6
#: the first radius of the step table, in pixels
MIN_RADIUS = 1.5
_R2_PHI = 0.6180339887498949  # golden-ratio rotation per frame


@functools.lru_cache(maxsize=1)
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for name in ("cosf", "sinf"):
        getattr(lib, name).restype = ctypes.c_float
        getattr(lib, name).argtypes = [ctypes.c_float]
    lib.powf.restype = ctypes.c_float
    lib.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    return lib


@functools.lru_cache(maxsize=64)
def step_table(frame: int, h: int, w: int, dirs: int, steps: int,
               min_radius: float):
    """(table (dirs * steps, 3) [dy, dx, s_eff], radii_prev (steps,), xi)
    in float32 (`ops/ssgi_sweep.py:156-181`): radii geometric from
    ``min_radius`` to the frame diagonal, bin angles rotated by ``xi``,
    texel offsets rounded half to even, and s_eff the screen distance of
    the rounded offset along the bin direction."""
    f32 = np.float32
    lib = _libm()
    xi = np.mod(f32(frame) * f32(_R2_PHI), f32(1.0))
    bin_width = f32(2.0 * math.pi / dirs)
    base = f32((h * h + w * w) ** 0.5 / min_radius)
    expo = np.arange(steps, dtype=f32) / f32(steps - 1)
    radii = f32(min_radius) * np.array(
        [lib.powf(float(base), float(e)) for e in expo], f32)
    ang = (np.arange(dirs, dtype=f32) + xi) * bin_width
    cos = np.array([lib.cosf(float(a)) for a in ang], f32)[:, None]
    sin = np.array([lib.sinf(float(a)) for a in ang], f32)[:, None]
    dxs = np.round(radii[None, :] * cos)
    dys = np.round(radii[None, :] * sin)
    s_eff = dxs * cos + dys * sin
    table = np.stack([dys.reshape(-1), dxs.reshape(-1), s_eff.reshape(-1)], -1)
    radii_prev = np.concatenate([np.zeros(1, f32), radii[:-1]])
    for a in (table, radii_prev):
        a.setflags(write=False)
    return table, radii_prev, float(xi)


@functools.lru_cache(maxsize=8)
def _frame_size(w: int, h: int, device: str) -> torch.Tensor:
    """[w, h] as a float32 tensor, copied to ``device`` once."""
    return torch.tensor([float(w), float(h)], device=device)


def _project_ray(view_pos, l, cam, height: int, width: int):
    """Screen-line parametrisation of the view-space ray: origin q0
    (pixels), unit screen direction e_hat, |K| (t(s) = s w0^2 /
    (|K| - s w0 wd)), and the clip w of the origin and its increment."""
    p = cam.projection_matrix
    sx, sy = float(np.float32(width * 0.5)), float(np.float32(height * 0.5))
    xy0, w0 = math3d.transform_point_nodiv(p, view_pos)
    x0, y0 = xy0[..., 0] * sx, xy0[..., 1] * sy
    lx, ly, lz = l[..., 0], l[..., 1], l[..., 2]
    xd = (float(p[0, 0]) * lx + float(p[0, 1]) * ly + float(p[0, 2]) * lz) * sx
    yd = (float(p[1, 0]) * lx + float(p[1, 1]) * ly + float(p[1, 2]) * lz) * sy
    wd = float(p[3, 0]) * lx + float(p[3, 1]) * ly + float(p[3, 2]) * lz
    w0c = torch.clamp(w0, min=EPS)
    q0 = torch.stack([x0 / w0c + sx, y0 / w0c + sy], dim=-1)
    k = torch.stack([xd * w0 - x0 * wd, yd * w0 - y0 * wd], dim=-1)
    k_len = math3d.length(k)
    e_hat = k / torch.clamp(k_len, min=EPS)[..., None]
    return q0, e_hat, k_len, w0, wd


def _t_of_s(s, k_len, w0, wd):
    """Ray parameter t at screen distance s (pixels), and its denominator."""
    denom = k_len - s * (w0 * wd)
    return s * (w0 * w0) / torch.where(denom.abs() > EPS, denom, EPS), denom


def _s_of_t(t, k_len, w0, wd):
    """Inverse of :func:`_t_of_s`."""
    return k_len * t / torch.clamp(w0 * (w0 + t * wd), min=EPS)


def march_inputs(view_pos, rays, depth_tex, cam, frame: int, ray_distance,
                 dirs: int = 16, steps: int = 32, min_radius: float = MIN_RADIUS,
                 bin_noise=None, frame_height: int | None = None):
    """What the sweep kernel reads, for ``rays`` (list of (H, W, 3)
    view-space directions): (z_tex, planes, table, radii_prev, per_ray),
    ``per_ray`` holding each ray's (q0, e_hat, k_len, w0, wd, s_end) for
    the steps after the march. Every plane is a function of the pixel
    alone: a row block of a larger frame passes the frame's height, which
    the step table and the screen projection are defined against."""
    h, w = depth_tex.shape
    h = h if frame_height is None else int(frame_height)
    table, radii_prev, xi = step_table(int(frame), h, w, dirs, steps,
                                       float(min_radius))
    bin_width = 2.0 * math.pi / dirs
    rd = float(np.float32(ray_distance))
    planes = [view_pos[..., 2]]
    per_ray = []
    for l in rays:
        q0, e_hat, k_len, w0, wd = _project_ray(view_pos, l, cam, h, w)
        phi = torch.atan2(e_hat[..., 1], e_hat[..., 0])
        rnd = 0.5 if bin_noise is None else bin_noise
        bin_idx = torch.remainder(torch.floor(phi / bin_width - xi + rnd),
                                  float(dirs))
        # screen length of the whole ray; a far end behind the eye runs
        # to the vanishing point
        s_end = torch.where(w0 + rd * wd > EPS, _s_of_t(rd, k_len, w0, wd),
                            math.inf)
        planes += [k_len, w0 * w0, w0 * wd, l[..., 2], bin_idx, s_end]
        per_ray.append((q0, e_hat, k_len, w0, wd, s_end))
    return (math3d.depth_to_view_z(depth_tex, cam), torch.stack(planes, dim=0),
            table, radii_prev, per_ray)


def sweep_results(view_pos, rays, per_ray, marched, h: int, w: int,
                  ray_distance):
    """Per ray (uv, hit_pos, missed[, gi]) from the march's (hit, s_hit,
    s_lo, z_d, gi): the deferred analytic refine, the miss uv (the ray
    end or the frame exit) and the view-space hit. Per pixel; ``h``,
    ``w`` the frame's size."""
    dev = view_pos.device
    diag = float((h * h + w * w) ** 0.5)
    z0 = view_pos[..., 2]
    size = _frame_size(w, h, str(dev))
    results = []
    for l, (q0, e_hat, k_len, w0, wd, s_end), (hit, s_hit, s_lo, z_d, gi) in \
            zip(rays, per_ray, marched):
        # deferred analytic refine: s* where z_ray(s) == z_d, clamped to
        # the bracketing step interval (`ops/ssgi_sweep.py:319-327`)
        lz = l[..., 2]
        t_star = (z_d - z0) / torch.where(lz.abs() > EPS, lz, EPS)
        s_ref = torch.minimum(torch.maximum(_s_of_t(t_star, k_len, w0, wd),
                                            s_lo), s_hit)
        s_ref = torch.where((t_star >= 0.0) & (t_star <= ray_distance),
                            s_ref, s_hit)
        s_hit = torch.where(hit, s_ref, s_hit)

        # miss uv: the ray end or the frame exit, whichever comes first
        missed = ~hit
        ex, ey = e_hat[..., 0], e_hat[..., 1]
        qx, qy = q0[..., 0], q0[..., 1]
        sx = torch.where(ex > EPS, (w - qx) / ex,
                         torch.where(ex < -EPS, -qx / ex, math.inf))
        sy = torch.where(ey > EPS, (h - qy) / ey,
                         torch.where(ey < -EPS, -qy / ey, math.inf))
        s_exit = torch.minimum(torch.minimum(sx, sy),
                               torch.clamp(s_end, max=diag))
        s_out = torch.where(missed, torch.clamp(s_exit, min=0.0), s_hit)
        uv = (q0 + s_out[..., None] * e_hat) / size
        t_hit, _ = _t_of_s(s_out, k_len, w0, wd)
        hit_pos = torch.where(missed[..., None], 1.0e9,
                              view_pos + t_hit[..., None] * l)
        out = (uv, hit_pos, missed)
        results.append(out if gi is None else out + (gi.float(),))
    return results


def sweep_ray_march(view_pos, rays, depth_tex, cam, frame: int, thickness,
                    ray_distance, dirs: int = 16, steps: int = 32,
                    min_radius: float = MIN_RADIUS, bin_noise=None, radiance=None,
                    miss_radiance: bool = False):
    """Trace ``rays`` (list of (H, W, 3) view-space directions) against
    the depth buffer. Returns per ray (uv, hit_pos, missed) with uv in
    [0, 1]^2 and hit_pos in view space (1e9 on a miss), plus ``gi``
    (H, W, 4) float32 when ``radiance`` ((H, W, 4), stored as float16)
    is given: the radiance at the hit step's texel, or with
    ``miss_radiance`` at the march-end texel of a missed ray.

    ``bin_noise`` ((H, W) in [0, 1)) rounds the bin stochastically; None
    rounds to the nearest bin."""
    h, w = depth_tex.shape
    z_tex, planes, table, radii_prev, per_ray = march_inputs(
        view_pos, rays, depth_tex, cam, frame, ray_distance, dirs, steps,
        min_radius, bin_noise)
    marched = sweep_march(
        z_tex, None if radiance is None else radiance.to(torch.float16),
        planes, table, radii_prev, thickness, ray_distance, len(rays), dirs,
        steps, miss_gi=miss_radiance)
    return sweep_results(view_pos, rays, per_ray, marched, h, w, ray_distance)
