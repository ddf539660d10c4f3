"""SSGI's shade pass on the card: one launch of ``csrc/shade.cu``'s
``shade_kernel`` a pass.

The plain route, :func:`ops.ssgi._shade_plain`, is some 780 whole-frame
torch operations for the sweep's two rays (1150 with the march's
fetches); the kernel computes a pixel's both rays, the environment
fallback, the weighting and the two packed outputs in one thread, with
the plain route's operations in its order, so the two agree bit for bit
on the card (``-fmad=false``; atan2f, acosf and powf are the card's on
both sides). It reads the setup's planes where they are (a view such as
the albedo's first three channels in place), the traces, the direct
light and the environment's float16 mip atlas. The scalars travel in the
launch parameters: nothing is uploaded. The branches come from the
inputs: the trace mode (a template parameter of the kernel), the mode's
rays, the environment, ``env_box``, ``missed_rays``, ``env_lum_clamp``,
``use_direct_light`` and the row block.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import cuda_build

MAX_LEVELS = 16   # csrc/shade.cu kMaxLevels

#: the planes in the order of ``csrc/shade.cu``'s ``enum Plane``
PLANES = ("depth", "roughness", "metalness", "diffuse", "roughness_sq", "nov",
          "view_normal", "n", "v", "is_diffuse_sample", "is_env_sample", "ems_pdf",
          "world_pos", "ray0", "ray1", "coords0", "coords1", "hit_pos", "missed0",
          "missed1", "radiance0", "radiance1", "direct_light", "velocity", "accumulated",
          "atlas", "g_diffuse", "g_specular")

_BORDER = 0.15   # ops/ssgi.py's border fade
# the host scalars the plain route divides by, in csrc/shade.cu's order:
# pi, 2 pi, the roughness mip scale's 0.15, the border fade's two
# smoothstep spans (e1 - e0)
_DIVISORS = np.array([math.pi, 2.0 * math.pi, 0.15, _BORDER - 0.0,
                      (1.0 - _BORDER) - 1.0], np.float32)


def _pixel_strided(t: torch.Tensor, lead: tuple, channels: int | None):
    """``t``, an (*lead[, channels]) tensor, as (tensor, stride) with pixel
    i at element i * stride of it and its channels adjacent: in place
    where its layout allows (a view of the first channels of a wider
    tensor), else a contiguous copy."""
    shape = lead + (() if channels is None else (channels,))
    if tuple(t.shape) != shape:
        raise ValueError(f"a plane of {tuple(t.shape)}, not {shape}")
    dense = channels or 1
    if t.is_contiguous():
        return t, dense
    ps = t.stride(1)
    if (channels is not None and t.stride(2) != 1) or ps < dense or t.stride(0) != lead[1] * ps:
        return t.contiguous(), dense
    return t, ps


def shade(p: dict, traces, velocity_tex, accumulated, direct_light, env, cam,
          frame: int, cfg, env_blur):
    """:func:`ops.ssgi._shade` for CUDA tensors, same arguments and
    results: (g_diffuse, g_specular), (h, w, 4) float32 each."""
    sweep = cfg.trace == "sweep"
    two_rays = cfg.mode == "ssgi"
    h, w = p["depth"].shape
    dev = p["depth"].device
    row_offset, fh = p["rows"]
    planes, strides = {}, {}

    def put(name, t, lead=(h, w), channels=None, dtype=torch.float32):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, not {dtype} on {dev}")
        planes[name], strides[name] = _pixel_strided(t, lead, channels)

    for name, c in (("depth", None), ("roughness", None), ("metalness", None),
                    ("diffuse", 3), ("roughness_sq", None), ("nov", None),
                    ("view_normal", 3), ("n", 3), ("v", 3), ("ems_pdf", None),
                    ("world_pos", 3)):
        put(name, p[name], channels=c)
    for name in ("is_diffuse_sample", "is_env_sample"):
        put(name, p[name], dtype=torch.bool)
    put("direct_light", direct_light, channels=3)
    n_rays = 2 if two_rays else 1
    if len(p["rays"]) != n_rays or len(traces) != n_rays:
        raise ValueError(f"mode {cfg.mode!r} takes {n_rays} rays and traces")
    for k in range(n_rays):
        put(f"ray{k}", p["rays"][k], channels=3)
        put(f"coords{k}", traces[k][0], channels=2)
        put(f"missed{k}", traces[k][2], dtype=torch.bool)
        if sweep:
            put(f"radiance{k}", traces[k][3], channels=4)
    put("hit_pos", traces[0][1], channels=3)
    vel_hw = acc_hw = (0, 0)
    if not sweep:
        vel_hw = tuple(velocity_tex.shape[:2])
        acc_hw = tuple(accumulated.shape[:2])
        put("velocity", velocity_tex, vel_hw, 2)
        put("accumulated", accumulated[..., :3], acc_hw, 3)

    levels, atlas_hw, shapes = 0, (0, 0), ()
    if env is not None:
        shapes = env.atlas.shapes
        levels = len(shapes)
        if levels > MAX_LEVELS:
            raise ValueError(f"the shade kernel takes at most {MAX_LEVELS} mip levels")
        atlas_hw = tuple(env.atlas.data.shape[:2])
        put("atlas", env.atlas.data, atlas_hw, 3, torch.float16)
    for name in ("g_diffuse", "g_specular"):
        planes[name], strides[name] = torch.empty((h, w, 4), device=dev), 4
    cuda_build.require_cuda(planes["g_diffuse"], planes["g_specular"])

    f32 = np.float32
    box = cfg.env_box
    if box is not None:
        size, pos = np.asarray(box[0], f32), np.asarray(box[1], f32)
        box_f = np.concatenate([f32(0.5) * size + pos, f32(-0.5) * size + pos, pos])
    else:
        box_f = np.zeros(9, f32)
    mip = float(env_blur) * float(env.max_mip_level) if env is not None else 0.0
    fparams = np.concatenate([
        np.asarray(cam.camera_matrix_world, f32).reshape(-1),
        np.asarray(cam.view_matrix, f32).reshape(-1),
        np.asarray(cam.position, f32).reshape(3), np.array([mip], f32), box_f,
        _DIVISORS, f32(1) / _DIVISORS]).astype(f32)
    stride = max(int(cfg.env_fetch_stride), 1) if sweep else 1
    level_rows = np.zeros((MAX_LEVELS, 3), np.int64)
    level_rows[:levels] = np.asarray(shapes, np.int64).reshape(-1, 3)
    iparams = np.concatenate([
        np.array([h, w, fh, row_offset, int(two_rays), int(cfg.missed_rays),
                  int(env is not None), int(cfg.env_lum_clamp), int(cfg.use_direct_light),
                  int(box is not None), stride, frame % stride, frame // stride % stride,
                  int(dev.type == "cuda"),
                  *vel_hw, *acc_hw, *atlas_hw, levels]),
        level_rows.reshape(-1), [strides.get(k, 0) for k in PLANES]]).astype(np.int32)
    ptrs = (ctypes.c_void_p * len(PLANES))(
        *(planes[k].data_ptr() if k in planes else None for k in PLANES))
    cuda_build.launch("shade", "shade", "re_shade", (0, 1, 3), planes["g_diffuse"],
                      int(sweep), ctypes.addressof(ptrs), iparams.ctypes.data,
                      fparams.ctypes.data)
    return planes["g_diffuse"], planes["g_specular"]
