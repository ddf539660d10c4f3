"""Disney BRDF evaluation and sampling over pixels
(`ssgi_utils.frag:94-191`, `hbao_utils.glsl:84-92`): GGX-VNDF sampling,
Smith geometry, Schlick Fresnel, Disney diffuse, the cosine-hemisphere
sampler. Same functions, argument order and operation order as the JAX
package's ``core/brdf.py``."""

from __future__ import annotations

import math

import torch

from .. import tracing
from .math3d import dot, normalize

EPSILON = 1e-5
ONE_MINUS_EPSILON = 1.0 - EPSILON
PI = math.pi


def cross(a, b):
    """Cross product over the last axis, (..., 3)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def f_schlick(f0, theta):
    """Schlick Fresnel; ``f0`` may be scalar (...) or colour (..., 3)."""
    p = (1.0 - theta) ** 5.0
    if f0.ndim == theta.ndim + 1:
        p = p[..., None]
    return f0 + (1.0 - f0) * p


def f_schlick_scalar(f0, f90, theta):
    return f0 + (f90 - f0) * (1.0 - theta) ** 5.0


def d_gtr(roughness, noh, k=2.0):
    a2 = roughness ** 2.0
    return a2 / (PI * ((noh * noh) * (a2 * a2 - 1.0) + 1.0) ** k)


def smith_g(ndotv, alpha_g):
    a = alpha_g * alpha_g
    b = ndotv * ndotv
    return (2.0 * ndotv) / (ndotv + torch.sqrt(a + b - a * b))


def ggx_vndf_pdf(noh, nov, roughness):
    d = d_gtr(roughness, noh, 2.0)
    g1 = smith_g(nov, roughness * roughness)
    return (d * g1) / torch.clamp(4.0 * nov, min=1e-5)


def geometry_term(nol, nov, roughness):
    a2 = roughness * roughness
    return smith_g(nov, a2) * smith_g(nol, a2)


def eval_disney_diffuse(nol, nov, loh, roughness, metalness):
    """Scalar Disney diffuse (`ssgi_utils.frag:136-142`)."""
    fd90 = 0.5 + 2.0 * roughness * loh ** 2.0
    a = f_schlick_scalar(1.0, fd90, nol)
    b = f_schlick_scalar(1.0, fd90, nov)
    return (a * b / PI) * (1.0 - metalness)


def eval_disney_specular(roughness, noh, nov, nol):
    """Scalar Disney specular (`ssgi_utils.frag:144-151`)."""
    d = d_gtr(roughness, noh, 2.0)
    g = geometry_term(nol, nov, (0.5 + roughness * 0.5) ** 2.0)
    return d * g / (4.0 * nol * nov)


def sample_ggx_vndf(v, ax, ay, r1, r2):
    """GGX visible-normal sampling (`ssgi_utils.frag:153-170`): the half
    vector in the local frame (z up) of the local view vector ``v``.
    ``r1``/``r2`` are tensors or floats."""
    r1 = tracing.to_device(r1, v.device, v.dtype, "brdf.ggx_r1")
    r2 = tracing.to_device(r2, v.device, v.dtype, "brdf.ggx_r2")
    vh = normalize(torch.stack([ax * v[..., 0], ay * v[..., 1], v[..., 2]],
                               dim=-1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    has_len = lensq > 0.0
    inv_len = torch.where(
        has_len, 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-20)), 0.0)
    zero = torch.zeros_like(inv_len)
    t1 = torch.where(
        has_len[..., None],
        torch.stack([-vh[..., 1] * inv_len, vh[..., 0] * inv_len, zero], -1),
        torch.stack([zero + 1.0, zero, zero], -1))
    t2 = cross(vh, t1)

    r = torch.sqrt(r1)
    phi = 2.0 * PI * r2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    nh = (p1[..., None] * t1 + p2[..., None] * t2
          + torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))[..., None]
          * vh)
    return normalize(torch.stack(
        [ax * nh[..., 0], ay * nh[..., 1], torch.clamp(nh[..., 2], min=0.0)],
        dim=-1))


def onb(n):
    """Orthonormal basis around ``n`` (`ssgi_utils.frag:172-176`);
    returns (t, b)."""
    zero = torch.zeros_like(n[..., 0])
    up = torch.where((n[..., 2].abs() < 0.9999999)[..., None],
                     torch.stack([zero, zero, zero + 1.0], -1),
                     torch.stack([zero + 1.0, zero, zero], -1))
    t = normalize(cross(up, n))
    return t, cross(n, t)


def to_local(t, b, n, v):
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], dim=-1)


def to_world(t, b, n, v):
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def hemisphere_basis(n: torch.Tensor):
    """The tangent frame of :func:`cosine_sample_hemisphere` around
    normal ``n`` (..., 3): ``b = normalize(cross(n, (0, 1, 1)))``,
    ``t = cross(b, n)``."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    b = normalize(torch.stack([ny - nz, -nx, nx], dim=-1))
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    t = torch.stack([by * nz - bz * ny, bz * nx - bx * nz,
                     bx * ny - by * nx], dim=-1)
    return b, t


def cosine_sample_hemisphere(n: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted direction around normal ``n`` (..., 3) from two
    uniforms ``u`` (..., 2) (`ssgi_utils.frag:183-191`), in the frame of
    :func:`hemisphere_basis`."""
    r = torch.sqrt(u[..., 0])
    theta = u[..., 1] * (2.0 * math.pi)
    b, t = hemisphere_basis(n)
    k1 = (r * torch.sin(theta))[..., None]
    k2 = torch.sqrt(torch.clamp(1.0 - u[..., 0], min=0.0))[..., None]
    k3 = (r * torch.cos(theta))[..., None]
    return normalize(k1 * b + k2 * n + k3 * t)


def mis_heuristic(a, b):
    """Power heuristic (`ssgi_utils.frag:227-231`)."""
    aa = a * a
    return aa / (aa + b * b)


def calculate_angles(l, v, n):
    """h, NoL, NoH, LoH, VoH with the reference's clamping
    (`ssgi.frag:93-100`)."""
    h = normalize(v + l)
    clamp = lambda x: torch.clamp(x, EPSILON, ONE_MINUS_EPSILON)
    return h, clamp(dot(n, l)), clamp(dot(n, h)), clamp(dot(l, h)), \
        clamp(dot(v, h))
