"""Temporal reprojection on the card: ``csrc/reproject.cu``'s two
kernels around the fetches of :func:`ops.temporal_reproject.temporal_reproject`.

The plain route (``temporal_reproject_plain``) is some 250 whole-frame
torch operations a slot around the warp and minmax kernels. On the card
:func:`reproject` launches, a reprojection:

1. ``reproject_prepare_kernel`` (:func:`prepare`): the per-pixel
   geometry, and what the fetches read: the last frame's packed normal
   and depth, the nearest probes' targets at the diffuse and the hit uv,
   each slot's Catmull-Rom targets and fractions and its history rounded
   through float16;
2. the fetches the plain route launches, unchanged: ``window_warp``'s
   nearest mode a probe, its catrom5 mode a slot, ``neighborhood_minmax``
   at radius 2 a slot and at radius 1 for a specular slot;
3. ``reproject_blend_kernel`` (:func:`blend`): the confidences, the
   clamp, the selects and the accumulation, every slot's RGBA output.

Both kernels take the plain route's operations in its order, so they
agree with it bit for bit (``-fmad=false``; the card's logf, expf and
powf on both sides). The scalars travel in the launch parameters:
nothing is uploaded, so the camera position's upload (and its host
wait) is gone. The branches come from the inputs: the configuration's
slots, specular slots, input type, log transform and dilation, whether
a roughness texture is given, the row block.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build
from .stencil import neighborhood_minmax
from .warp import window_warp

MAX_SLOTS = 2   # csrc/reproject.cu kMaxSlots: SSGI's two; TRAA and SSR take one


def _slots(name: str) -> tuple:
    return tuple(f"{name}{s}" for s in range(MAX_SLOTS))


#: the device pointers of ``ReprojectPlanes``, in its order
PLANES = ("vel", "normal", "depth", "last_normal", "last_depth", "ray", "rough",
          *_slots("history"), *_slots("input"), "probe_nd0", "probe_nd1",
          "probe_ok0", "probe_ok1", *_slots("fetched"), *_slots("box_min2"),
          *_slots("box_max2"), *_slots("box_min1"), *_slots("box_max1"), "nd",
          "targets", "fracs", *_slots("history16"), *_slots("out"))

# the host scalars a plain route divides by: the disocclusion scales
# (`reproject.frag:107-109`) and the roughness maximum
# (`temporal_reproject.frag:68`)
_DIVISORS = np.array([10.0, 20.0, 1.0, 0.1], np.float32)
# ATen's pow of a float tensor by a host scalar: fill, copy, sqrt and
# the two products; any other exponent is powf
_POW_LAW = {0.0: 4, 1.0: 5, 0.5: 3, 2.0: 1, 3.0: 2}


def _pow_law(e: float) -> int:
    e = float(e)
    if e in (-0.5, -1.0, -2.0):
        raise ValueError(f"the reprojection kernels do not take a confidence power of {e}")
    return _POW_LAW.get(e, 0)


def _params(cfg, cam, prev_cam, shape, row_offset, fh, max_value,
            clamp_intensity, spec_mask, ray_stride, rough_stride, recip):
    f32 = np.float32
    h, w = shape
    mats = (cam.camera_matrix_world, cam.projection_matrix_inverse,
            prev_cam.camera_matrix_world, prev_cam.projection_matrix_inverse,
            prev_cam.view_matrix, prev_cam.projection_matrix)
    near, far = f32(cam.near), f32(cam.far)
    perspective = float(cam.projection_matrix[3, 2]) != 0.0
    law = (near * far, far - near, far) if perspective else (near - far, near, f32(0))
    fparams = np.concatenate(
        [np.asarray(m, f32).reshape(-1) for m in mats]
        + [np.asarray(cam.position, f32).reshape(3), np.array(law, f32),
           np.array([max_value, clamp_intensity, cfg.confidence_power,
                     f32(1) / f32(w), f32(1) / f32(fh)], f32),
           _DIVISORS, f32(1) / _DIVISORS]).astype(f32)
    iparams = np.array([h, w, fh, row_offset, cfg.texture_count, spec_mask,
                        int(cfg.input_type != "diffuse"), int(cfg.log_transform),
                        int(cfg.dilation), int(perspective), int(recip),
                        _pow_law(cfg.confidence_power), ray_stride, rough_stride],
                       np.int32)
    return iparams, fparams


def _addr(v):
    if v is None or isinstance(v, int):
        return v
    return v.data_ptr()


def _launch(stage: int, planes: dict, iparams, fparams, like: torch.Tensor):
    unknown = set(planes) - set(PLANES)
    if unknown:
        raise ValueError(f"unknown planes {sorted(unknown)}")
    ptrs = (ctypes.c_void_p * len(PLANES))(*(_addr(planes.get(k)) for k in PLANES))
    # the blend is counted by slots: "reproject_2slot" SSGI's, "_1slot"
    # TRAA's and SSR's
    key = "reproject_prepare" if stage == 0 else f"reproject_{int(iparams[4])}slot"
    cuda_build.launch(key, "reproject", "re_reproject", (0, 1, 3), like, stage,
                      ctypes.addressof(ptrs), iparams.ctypes.data, fparams.ctypes.data)


def prepare(planes: dict, iparams, fparams, like: torch.Tensor):
    """Launch ``reproject_prepare_kernel`` over ``planes`` (names of
    :data:`PLANES`), writing ``nd``, ``targets``, ``fracs`` and each
    slot's ``history16``."""
    _launch(0, planes, iparams, fparams, like)


def blend(planes: dict, iparams, fparams, like: torch.Tensor):
    """Launch ``reproject_blend_kernel`` over ``planes``, writing each
    slot's ``out``."""
    _launch(1, planes, iparams, fparams, like)


def _alpha(t: torch.Tensor) -> int:
    """The address of an (H, W, 4) tensor's alpha channel (stride 4)."""
    return t.data_ptr() + 3 * t.element_size()


def reproject(inputs, history, velocity, last_velocity, cam, prev_cam, cfg,
              max_blend: float = 1.0, neighborhood_clamp_intensity: float = 1.0,
              full_accumulate: bool = False, keep_data: float = 1.0,
              roughness_tex=None, row_offset: int = 0,
              frame_height: int | None = None):
    """:func:`ops.temporal_reproject.temporal_reproject` on the card, same
    arguments and results: the prepare kernel, the fetches, the blend
    kernel. CUDA tensors only (the host build of the sources in the
    tests runs it on CPU tensors, the fetches there taking their plain
    versions)."""
    n = cfg.texture_count
    if not len(inputs) == n == len(history):
        raise ValueError("inputs, history and texture_count disagree")
    if n > MAX_SLOTS:
        raise ValueError(f"the reprojection kernels take at most {MAX_SLOTS} slots, not {n}")
    h, w = velocity.depth.shape
    fh = h if frame_height is None else int(frame_height)
    dev = velocity.depth.device
    spec = [bool(cfg.reproject_specular[s]) for s in range(n)]
    spec_mask = sum(1 << s for s in range(n) if spec[s])
    n_probes = 2 if spec_mask else 1
    inputs = [t.contiguous() for t in inputs]
    history = [t.contiguous() for t in history]
    geo = [velocity.velocity, velocity.normal, velocity.depth, last_velocity.normal,
           last_velocity.depth]
    geo = [t.contiguous() for t in geo]
    shapes = [(h, w, 2), (h, w, 3), (h, w), (h, w, 3), (h, w)]
    if [tuple(t.shape) for t in geo] != shapes or any(
            tuple(t.shape) != (h, w, 4) for t in (*inputs, *history)):
        raise ValueError("the velocity buffers, inputs and history do not match")
    cuda_build.require_cuda(*geo, *inputs, *history)
    if any(t.dtype != torch.float32 for t in (*geo, *inputs, *history)):
        raise ValueError("the reprojection kernels take float32 tensors")

    # ray length and roughness (`temporal_reproject.frag:167-176`)
    ray = rough = None
    ray_stride = rough_stride = 0
    if cfg.input_type == "diffuse_specular":
        ray, ray_stride = _alpha(inputs[1]), 4
        rough, rough_stride = _alpha(inputs[0]), 4
    elif cfg.input_type == "specular":
        ray, ray_stride = _alpha(inputs[0]), 4
        if roughness_tex is not None:
            roughness_tex = roughness_tex.contiguous()
            if tuple(roughness_tex.shape) != (h, w) or roughness_tex.dtype != torch.float32:
                raise ValueError(f"roughness of {tuple(roughness_tex.shape)} "
                                 f"{roughness_tex.dtype} for {h}x{w} float32")
            cuda_build.require_cuda(geo[0], roughness_tex)
            rough, rough_stride = roughness_tex, 1
    max_value = (1.0 if full_accumulate else float(max_blend)) * float(keep_data)
    # PyTorch on CUDA divides by a host scalar as a product with its
    # float32 reciprocal, on the CPU it divides: the kernels follow the
    # plain route of the tensors' device
    iparams, fparams = _params(cfg, cam, prev_cam, (h, w), int(row_offset), fh, max_value,
                               float(neighborhood_clamp_intensity), spec_mask, ray_stride,
                               rough_stride, dev.type == "cuda")

    nd = torch.empty((h, w, 4), device=dev)
    targets = torch.empty((2 * n_probes + 2 * n, h, w), dtype=torch.int32, device=dev)
    fracs = torch.empty((2 * n, h, w), device=dev)
    history16 = [torch.empty((h, w, 4), device=dev) for _ in range(n)]
    planes = dict(vel=geo[0], normal=geo[1], depth=geo[2], last_normal=geo[3],
                  last_depth=geo[4], ray=ray, rough=rough, nd=nd, targets=targets,
                  fracs=fracs)
    for s in range(n):
        planes[f"history{s}"] = history[s]
        planes[f"history16{s}"] = history16[s]
        planes[f"input{s}"] = inputs[s]
    prepare(planes, iparams, fparams, nd)

    win = dict(ky=cfg.window_ky, kx=cfg.window_kx)
    for k in range(n_probes):
        last_nd, ok = window_warp(nd, targets[2 * k], targets[2 * k + 1], mode="nearest",
                                  **win)
        planes[f"probe_nd{k}"], planes[f"probe_ok{k}"] = last_nd.contiguous(), ok.contiguous()
    for s in range(n):
        t = 2 * n_probes + 2 * s
        fetched, _ = window_warp(history16[s], targets[t], targets[t + 1], fy=fracs[2 * s],
                                 fx=fracs[2 * s + 1], mode="catrom5", **win)
        planes[f"fetched{s}"] = fetched.contiguous()
    # the blend reads none of the prepare kernel's outputs: their memory
    # goes back to the allocator for the clamp boxes and the outputs
    for k in ("nd", "targets", "fracs", *_slots("history16")):
        planes.pop(k, None)
    del nd, targets, fracs, history16
    for s in range(n):
        for r in (1, 2) if spec[s] else (2,):
            planes[f"box_min{r}{s}"], planes[f"box_max{r}{s}"] = neighborhood_minmax(
                inputs[s], r)
    outs = [torch.empty((h, w, 4), device=dev) for _ in range(n)]
    for s in range(n):
        planes[f"out{s}"] = outs[s]
    blend(planes, iparams, fparams, inputs[0])
    return outs
