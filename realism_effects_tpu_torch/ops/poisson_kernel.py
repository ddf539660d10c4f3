"""Fused Poisson-denoise pass: one whole 8-tap pass in one kernel.

Kernel: ``csrc/poisson.cu``. It replaces the JAX package's
``ops/pallas/poisson.py::_poisson_kernel`` (``poisson_pass_fused``),
whose semantics are those of ``ops/poisson_denoise.py::
poisson_denoise_pass`` (`poisson_denoise.frag:94-190`) on the reference's
packed storage: a bundle [depth | oct-half2x16 normal | roughness |
half2x16 slots], float16 texels decoded exactly, background normals
packed as 0.0 decoding to (0, 0, 0), flatness from forward differences of
the decoded normal, the 8 Poisson offsets rotated in uv with the global
aspect, and x^e as exp(log(x) * e).

The TPU kernel also clamps each tap to a window around the pixel
(``poisson.py:198-200``). Its windows (``poisson.py:65-72``) are the
bound of the tap reach, so the clamp never binds and this kernel fetches
the frame-clamped texel directly; ``tests/test_torch_poisson.py`` checks
the equality where the windows are tight.

A row block of a larger frame takes ``row_offset`` (the global row of
its first row) and ``resolution`` (the global (H, W)), as the JAX pass
does: the uv, the flatness's bottom edge and the taps' frame clamp are
the global frame's, a tap row is re-based onto the block, and the noise
is rolled by the offset. The split frame's shards run it so on their
rows extended by :func:`tap_halo` halo rows.

On the H100 the pass is bound by instruction issue, not bytes: a thread
a pixel that decoded each of its 8 taps' texels itself ran about 160
accurate libm calls a two-slot pixel, each texel's work repeated about 8
times. The kernel computes the texel-only values (depth, decoded normal,
roughness, per slot the log rgb and its luminance) once a texel into
shared memory, for its 32 x 8 tile and a halo of the tap reach; the tap
loop keeps only the work that depends on the pixel. See the source.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.packing import pack_half2x16, pack_normal, unpack_half2x16
from ..core.rng import blue_noise_tile_tensor, noise_shift
from . import cuda_build

MAX_TEX = 4
#: route denoise passes through the fused kernel; off, through the
#: unfused pass of ``ops/poisson_denoise.py`` (the JAX package's
#: ``ops/pallas/poisson.py`` switch of the same name)
USE_FUSED_PASS = True
_PI2 = float(np.float32(2.0 * math.pi))
_SQRT2_4 = 0.25 * math.sqrt(2.0)
# `poisson_denoise.frag:91-92`
POISSON8 = (
    (-1.0, 0.0), (0.0, -1.0), (1.0, 0.0), (0.0, 1.0),
    (-_SQRT2_4, -_SQRT2_4), (_SQRT2_4, -_SQRT2_4),
    (_SQRT2_4, _SQRT2_4), (-_SQRT2_4, _SQRT2_4),
)
_LW = (0.2125, 0.7154, 0.0721)


def pack_bundle(textures, gbuffer, scalar_slots):
    """(H, W, Cb) bundle of the reference's packed storage, and the first
    bundle channel of each slot."""
    n_valid = gbuffer.normal.abs().sum(-1) > 1e-8
    packed_nrm = torch.where(n_valid, pack_normal(gbuffer.normal), 0.0)
    planes = [gbuffer.depth, packed_nrm, gbuffer.roughness]
    slot_ch = []
    for scalar, t in zip(scalar_slots, textures):
        slot_ch.append(len(planes))
        if scalar:
            planes.append(pack_half2x16(t[..., 0::3]))  # (value, alpha)
        else:
            planes.append(pack_half2x16(t[..., 0:2]))
            planes.append(pack_half2x16(t[..., 2:4]))
    return torch.stack(planes, dim=-1), slot_ch


def tap_halo(radius: float, hg: int, wg: int) -> int:
    """Rows a tap reaches from its pixel in a frame of hg x wg: the halo
    of the sharded route (the axis window ``aky`` of the JAX
    ``ops/pallas/poisson.py::_windows``)."""
    return int(math.ceil(radius * math.hypot(hg / wg, 1.0))) + 1


def _host_params(cfg, h: int, w: int) -> np.ndarray:
    """The kernel's float parameters for the global frame (h, w)."""
    vals = [cfg.radius, 1.2 * cfg.phi, cfg.luma_phi, cfg.depth_phi,
            cfg.normal_phi, cfg.roughness_phi, cfg.specular_phi,
            1.0 / w, 1.0 / h, float(w), float(h)]
    vals += [o[0] / w for o in POISSON8] + [o[1] / h for o in POISSON8]
    return np.array(vals, np.float64).astype(np.float32)


def _pow(x, e: float):
    return torch.exp(torch.log(x) * e)


def _luminance8(r, g, b):
    return _pow(torch.clamp(r * _LW[0] + g * _LW[1] + b * _LW[2], min=0.0),
                0.125)


def _unpack2(f):
    u = unpack_half2x16(f)
    return u[..., 0], u[..., 1]


def _unpack_normal3(packed):
    """Octahedral decode; a packed 0.0 gives (0, 0, 0)."""
    fx, fy = _unpack2(packed)
    fx = fx * 2.0 - 1.0
    fy = fy * 2.0 - 1.0
    z = 1.0 - fx.abs() - fy.abs()
    t = torch.clamp(-z, min=0.0)
    x = fx + torch.where(fx >= 0.0, -t, t)
    y = fy + torch.where(fy >= 0.0, -t, t)
    n = torch.clamp(torch.sqrt(x * x + y * y + z * z), min=1e-20)
    valid = packed.view(torch.int32) != 0
    return tuple(torch.where(valid, v / n, 0.0) for v in (x, y, z))


def _slot(b, ch, scalar):
    if scalar:
        v, alpha = _unpack2(b[..., ch])
        return (v, v, v), alpha
    r, g = _unpack2(b[..., ch])
    bl, alpha = _unpack2(b[..., ch + 1])
    return (r, g, bl), alpha


def tap_targets(rr, cc, angle, flatness, cfg, h: int, w: int,
                row_offset: int = 0, resolution=None):
    """(iy, ix) int32 of the 8 Poisson taps of pixels (rr, cc) of an
    (h, w) block at the blue-noise ``angle`` (`poisson_denoise.frag:185-190`):
    offsets rotated in uv with the global aspect, scaled by ``radius *
    flatness``, snapped to the nearest texel and clamped to the global
    frame ``resolution`` (default (h, w)); the row is then re-based by
    ``-row_offset`` and held to the block."""
    hg, wg = resolution if resolution is not None else (h, w)
    prm = [float(v) for v in _host_params(cfg, hg, wg)]
    inv_w, inv_h, wgf, hgf = prm[7:11]
    offx, offy = prm[11:19], prm[19:27]
    s_, c_ = torch.sin(angle), torch.cos(angle)
    rscale = prm[0] * flatness
    uvx = (cc.to(torch.float32) + 0.5) * inv_w
    uvy = ((rr + row_offset).to(torch.float32) + 0.5) * inv_h
    taps = []
    for k in range(8):
        ox = (c_ * offx[k] + s_ * offy[k]) * rscale
        oy = (-s_ * offx[k] + c_ * offy[k]) * rscale
        ix = torch.clamp(torch.floor((uvx + ox) * wgf).to(torch.int32), 0, wg - 1)
        iy = torch.clamp(torch.floor((uvy + oy) * hgf).to(torch.int32), 0, hg - 1)
        taps.append((torch.clamp(iy - row_offset, 0, h - 1), ix))
    return taps


def poisson_pass_plain(bundle, slot_ch, scalar_slots, noise_index: int, cfg,
                       row_offset: int = 0, resolution=None):
    """The kernel's function in PyTorch on the packed bundle, a row block
    of the frame ``resolution`` starting at global row ``row_offset``
    (default: the whole frame); returns the (H, W, 4 * n_tex) output."""
    h, w = bundle.shape[0], bundle.shape[1]
    hg, wg = resolution if resolution is not None else (h, w)
    dev = bundle.device
    prm = [float(v) for v in _host_params(cfg, hg, wg)]
    age_e, luma_phi, depth_phi, normal_phi, rough_phi, spec_phi = prm[1:7]
    spec = tuple(cfg.is_specular) + (False,) * len(slot_ch)

    d_c = bundle[..., 0]
    nc = _unpack_normal3(bundle[..., 1])
    rough_c = bundle[..., 2]
    right = torch.cat([bundle[:, 1:, 1], bundle[:, -1:, 1]], dim=1)
    down = torch.cat([bundle[1:, :, 1], bundle[-1:, :, 1]], dim=0)
    nr = _unpack_normal3(right)
    nd = _unpack_normal3(down)
    rr = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(h, w)
    cc = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(h, w)
    right_ok = (cc < wg - 1).to(torch.float32)
    down_ok = (rr + row_offset < hg - 1).to(torch.float32)
    fw2 = torch.zeros_like(d_c)
    for c0, cr, cd in zip(nc, nr, nd):
        fw = (cr - c0).abs() * right_ok + (cd - c0).abs() * down_ok
        fw2 = fw2 + fw * fw
    flatness = 1.0 - torch.clamp(torch.sqrt(fw2), max=1.0)
    flatness = flatness * flatness * 0.75 + 0.25

    sy, sx = noise_shift(noise_index, row_offset=row_offset)
    tile = blue_noise_tile_tensor(dev)
    angle = tile[((rr + sy) % 128).long(), ((cc + sx) % 128).long(), 0] * _PI2

    slots = []
    for s, ch in enumerate(slot_ch):
        raw, alpha = _slot(bundle, ch, scalar_slots[s])
        acc = [torch.log(x * 1.0003 + 1.0) for x in raw]
        slots.append({
            "raw": raw, "alpha": alpha, "acc": acc,
            "lum": _luminance8(*acc),
            "age": torch.reciprocal(_pow(alpha + 1.0, age_e)),
            "total": torch.ones_like(d_c),
        })
    glossiness = torch.clamp(4.0 * (1.0 - rough_c / 0.25), min=0.0)
    specular_factor = torch.exp(-glossiness * spec_phi)

    flat = bundle.reshape(h * w, -1)
    for iyt, ixt in tap_targets(rr, cc, angle, flatness, cfg, h, w,
                                row_offset, (hg, wg)):
        t = flat[(iyt * w + ixt).long()]
        n_depth = t[..., 0]
        nt = _unpack_normal3(t[..., 1])
        ndot = nc[0] * nt[0] + nc[1] * nt[1] + nc[2] * nt[2]
        normal_diff = 1.0 - torch.clamp(ndot, min=0.0)
        depth_diff = 10000.0 * (d_c - n_depth).abs()
        rough_diff = (rough_c - t[..., 2]).abs()
        w_basic = torch.exp(-normal_diff * normal_phi - depth_diff * depth_phi
                            - rough_diff * rough_phi)
        w_basic = torch.where(n_depth >= 1.0, 0.0, w_basic)
        for s, ch in enumerate(slot_ch):
            st = slots[s]
            traw, _ = _slot(t, ch, scalar_slots[s])
            wgt = w_basic * specular_factor if spec[s] else w_basic * 1.0
            tr = [torch.log(torch.clamp(x, min=0.0) + 1.0) for x in traw]
            disoccl_w = _pow(torch.clamp(wgt, min=1e-20), 0.1)
            luma_diff = torch.clamp((st["lum"] - _luminance8(*tr)).abs(), max=0.5)
            luma_factor = torch.exp(-luma_diff * luma_phi)
            wl = wgt * luma_factor
            wgt = (wl + (disoccl_w - wl) * st["age"]) * st["age"]
            wgt = wgt * (wgt >= 0.0001).to(torch.float32)
            st["acc"] = [a + wgt * x for a, x in zip(st["acc"], tr)]
            st["total"] = st["total"] + wgt

    is_bg = d_c >= 1.0
    planes = []
    for st in slots:
        for i in range(3):
            o = torch.exp(st["acc"][i] / st["total"]) - 1.0
            planes.append(torch.where(is_bg, st["raw"][i], o))
        planes.append(st["alpha"])
    return torch.stack(planes, dim=-1)


def poisson_pass_fused(textures, gbuffer, noise_index: int, cfg,
                       row_offset: int = 0, resolution=None,
                       scalar_slots=None):
    """One fused denoise pass over ``textures`` (each (H, W, 4)); returns
    the list of denoised (H, W, 4) textures. ``scalar_slots[i]`` marks a
    texture whose rgb is one replicated scalar (the AO path): it rides a
    single packed channel. ``row_offset`` and ``resolution``: the block's
    first global row and the global (H, W), for a row block of a larger
    frame. CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    n_tex = len(textures)
    if not 1 <= n_tex <= MAX_TEX:
        raise ValueError(f"the fused pass takes 1..{MAX_TEX} textures, not {n_tex}")
    scalar_slots = tuple(scalar_slots or (False,) * n_tex)
    bundle, slot_ch = pack_bundle(textures, gbuffer, scalar_slots)
    if resolution is not None and int(resolution[1]) != bundle.shape[1]:
        raise ValueError(f"a row block of {bundle.shape[1]} columns in a frame of "
                         f"{resolution[1]}: blocks split rows only")
    if bundle.device.type == "cpu":
        out = poisson_pass_plain(bundle, slot_ch, scalar_slots, noise_index,
                                 cfg, row_offset, resolution)
    else:
        out = _launch(bundle, slot_ch, scalar_slots, noise_index, cfg,
                      row_offset, resolution)
    return [out[..., 4 * s: 4 * s + 4] for s in range(n_tex)]


def _launch(bundle, slot_ch, scalar_slots, noise_index, cfg, row_offset=0,
            resolution=None):
    h, w, cb = bundle.shape
    hg, wg = resolution if resolution is not None else (h, w)
    n_tex = len(slot_ch)
    bundle = bundle.contiguous()
    tile = blue_noise_tile_tensor(bundle.device)
    cuda_build.require_cuda(bundle, tile)
    out = torch.empty((h, w, 4 * n_tex), dtype=torch.float32,
                      device=bundle.device)
    fparams = _host_params(cfg, hg, wg)
    spec = tuple(cfg.is_specular) + (False,) * n_tex
    iparams = list(noise_shift(noise_index, row_offset=row_offset))
    for s in range(n_tex):
        iparams += [slot_ch[s], int(scalar_slots[s]), int(spec[s])]
    iparams = np.array(iparams, np.int32)
    # counted as the AO pass ("poisson") or by its textures ("poisson_2tex":
    # SSGI's, "poisson_1tex": SSR's)
    key = "poisson" if tuple(scalar_slots) == (True,) else f"poisson_{n_tex}tex"
    cuda_build.launch(key, "poisson", "re_poisson", (3, 5, 2), bundle,
                      bundle.data_ptr(), tile.data_ptr(), out.data_ptr(), h, w, cb,
                      n_tex, int(row_offset), fparams.ctypes.data, iparams.ctypes.data)
    return out
