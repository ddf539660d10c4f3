"""The per-pixel ray march of SSGI and SSR on the card: one launch of
``csrc/sweep.cu``'s ``ray_march_kernel`` a ray.

The plain route is :func:`ops.ssgi.view_space_ray_march_plain`, some 30
whole-frame torch operations a step; the kernel runs each lane's steps
and bisections in one thread, with the plain route's operations in its
order, so the two agree bit for bit on the card (``-fmad=false``; expf,
the one libm call, is the same on both). A lane that has hit stops
stepping: the plain route holds its position from there on, so nothing
it computes afterwards changes the lane's result. The scalars travel in
the launch's parameters: nothing is uploaded.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_build


def launch(view_pos, l, depth_tex, cam, random_b, thickness, ray_distance,
           steps: int, refine_steps: int):
    """(uv, hit_pos, missed) of :func:`ops.ssgi.view_space_ray_march` for
    CUDA tensors: ``view_pos`` and ``l`` (..., 3), ``random_b`` (...),
    ``depth_tex`` (Hd, Wd), any size (a row block's lanes march against
    the whole frame's depth)."""
    lanes = tuple(view_pos.shape[:-1])
    n = int(np.prod(lanes, dtype=np.int64))
    if tuple(l.shape) != lanes + (3,) or tuple(random_b.shape) != lanes:
        raise ValueError(f"lanes {tuple(view_pos.shape)}, ray {tuple(l.shape)}, "
                         f"random {tuple(random_b.shape)} do not match")
    view_pos, l, depth_tex = (t.contiguous() for t in (view_pos, l, depth_tex))
    # SSGI's random number is a channel of the blue-noise image: read in
    # place, lane i at i * stride, where its strides allow
    rb_stride = random_b.stride(-1) if lanes else 1
    if rb_stride < 1 or any(random_b.stride(d) != rb_stride * int(np.prod(lanes[d + 1:]))
                            for d in range(len(lanes))):
        random_b, rb_stride = random_b.contiguous(), 1
    cuda_build.require_cuda(view_pos, l, depth_tex)
    if random_b.device != view_pos.device or random_b.dtype != torch.float32:
        raise ValueError("the random numbers must be float32 on the lanes' device")
    dev = view_pos.device
    uv = torch.empty(lanes + (2,), device=dev)
    hit_pos = torch.empty(lanes + (3,), device=dev)
    missed = torch.empty(lanes, dtype=torch.bool, device=dev)
    f32 = np.float32
    m = np.asarray(cam.projection_matrix, f32)
    near, far = f32(cam.near), f32(cam.far)
    perspective = float(m[3, 2]) != 0.0
    depth_law = (near * far, far - near, far) if perspective else (near - far, near, 0.0)
    fparams = np.concatenate([m[[0, 1, 3]].reshape(-1), np.array(
        [float(ray_distance) / float(steps), float(thickness), *depth_law], f32)]).astype(f32)
    cuda_build.launch("ray_march", "sweep", "re_ray_march", (7, 7, 1), view_pos,
                      view_pos.data_ptr(), l.data_ptr(), random_b.data_ptr(),
                      depth_tex.data_ptr(), uv.data_ptr(), hit_pos.data_ptr(),
                      missed.data_ptr(), n, int(depth_tex.shape[0]),
                      int(depth_tex.shape[1]), int(steps), int(refine_steps),
                      int(perspective), int(rb_stride), fparams.ctypes.data)
    return uv, hit_pos, missed
