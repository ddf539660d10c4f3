"""Motion-blur line integral (K12).

`src/motion-blur/shader/motion_blur.frag`: early-out when static (as a
mask), blue-noise jittered start/end uvs centred on the pixel (John
Chapman's per-object motion blur), ``samples + 1`` taps averaged with the
centre colour counted twice (`:35-42`).

Two discretisations of the same integral, as in the JAX package's
``ops/motion_blur.py``:

* :func:`motion_blur` -- the reference's: ``samples + 1`` bilinear taps
  at per-pixel uvs (the parity mode). CUDA tensors: one hand-written
  kernel, ``csrc/motion_blur.cu``'s ``motion_blur_taps_kernel``, a thread
  a pixel taking all its taps; CPU tensors: :func:`motion_blur_plain`.
* :func:`motion_blur_sweep` (the default) -- pixels bin by velocity
  direction (R2-rotated per frame), the segment integrates over a shared
  geometric radius ladder, and every (direction, radius) cell is one
  shifted read of the whole frame. Each pixel weights a cell by its
  overlap with the pixel's own jittered segment.

The JAX package serves a cell with a whole-frame ``jnp.roll`` of the
float16-packed frame and masks out-of-frame taps; here a cell reads a
shifted position of the float16 frame zero-padded by the largest offset,
with a fourth channel of ones that is 0 in the padding: out-of-frame taps
get weight 0 either way, so the values are the same. The cell table
(offsets, radii) is built on the host in float32 with the C library's
``cosf``/``sinf``/``powf``, the functions XLA's CPU backend calls.

The sweep's accumulate pass (:func:`accumulate`) has two routes:

* CPU tensors: :func:`accumulate_plain`, every one of the ``dirs x
  steps`` cells a shifted slice of the whole frame added to every pixel
  with ``addcmul_``, weighted 0 off the pixel's two direction bins.
* CUDA tensors: one hand-written kernel, ``csrc/motion_blur.cu``. A
  pixel lies in exactly two bins (``bin_pos``, ``bin_neg``; one where
  they coincide), so its thread walks only those, in ascending bin order
  as the loop does, and skips each cell whose weight is 0 (past the
  first radius ``e_lo[k] >= u`` on the increasing ladder): at most
  ``2 x steps`` texel reads a pixel, 24 at the defaults, instead of 192,
  and no (steps, H, W) weight planes. A skipped cell adds ``texel * +-0
  = +-0`` in the loop, which leaves a sum unchanged, and the kernel's
  products and sums are the loop's fused multiply-adds in the loop's
  order, so the two routes give the same sums bit for bit. The one
  exception: a texel that is not finite in float16 (HDR above 65504)
  makes ``0 * inf`` NaN in every zero-weight cell of the loop, which the
  kernel never reads. The cell table travels in the launch's
  parameters, so nothing is uploaded.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import tracing
from ..core.math3d import mix, uv_grid
from ..core.rng import blue_noise_image, blue_noise_tile_tensor, noise_shift
from ..core.sampling import sample_bilinear
from . import cuda_build
from .ssgi_sweep import _libm

_R2_PHI = 0.6180339887498949


def _frame_speed(delta_time) -> float:
    """(1 / 100) / deltaTime in float32 (`motion_blur.frag:27`)."""
    return float(np.float32(1.0 / 100.0) / np.float32(delta_time))


def motion_blur(color: torch.Tensor, velocity: torch.Tensor, frame: int,
                intensity=1.0, jitter=1.0, delta_time=1.0 / 60.0,
                samples: int = 16, row_offset: int = 0,
                source: torch.Tensor | None = None) -> torch.Tensor:
    """The reference's taps. A row block of a larger frame passes its
    first row's global index ``row_offset`` and the whole frame's colour
    as ``source`` (the taps read it anywhere); ``color`` and ``velocity``
    are the block's. CUDA tensors launch ``csrc/motion_blur.cu``'s
    ``motion_blur_taps_kernel`` (one thread a pixel, every tap); CPU
    tensors take :func:`motion_blur_plain`."""
    args = (color, velocity, frame, intensity, jitter, delta_time, samples,
            row_offset, source)
    with tracing.span("pass:motion_blur.taps"):
        if color.device.type == "cpu":
            return motion_blur_plain(*args)
        return _launch_taps(*args)


def motion_blur_plain(color, velocity, frame: int, intensity=1.0, jitter=1.0,
                      delta_time=1.0 / 60.0, samples: int = 16,
                      row_offset: int = 0, source=None) -> torch.Tensor:
    """:func:`motion_blur` as whole-frame torch operations, a tap at a
    time."""
    h, w = color.shape[:2]
    src = color if source is None else source
    uv = uv_grid(h, w, color.device, row_offset, src.shape[0])
    vel = velocity * float(intensity)
    did_move = (velocity * velocity).sum(-1) > 1e-9
    noise = blue_noise_image(h, w, frame, row_offset=row_offset,
                             device=color.device)
    jitter_offset = float(jitter) * vel * noise[..., :2]
    frame_speed = _frame_speed(delta_time)
    start_uv = torch.clamp(uv + (jitter_offset - vel * 0.5) * frame_speed, min=0.0)
    end_uv = torch.clamp(uv + (jitter_offset + vel * 0.5) * frame_speed, max=1.0)

    acc = color
    for i in range(samples + 1):
        # inputTexture is the composer's HalfFloat framebuffer
        # (`example/main.js` frameBufferType): half-precision taps
        tap_uv = mix(start_uv, end_uv, i / float(samples))
        acc = acc + sample_bilinear(src, tap_uv, half=True)
    blurred = acc / (float(samples) + 2.0)
    return torch.where(did_move[..., None], blurred, color)


def _launch_taps(color, velocity, frame: int, intensity, jitter, delta_time,
                 samples: int, row_offset: int, source) -> torch.Tensor:
    h, w = color.shape[:2]
    src = color if source is None else source
    color, velocity, src = (t.contiguous() for t in (color, velocity, src))
    if (color.shape != (h, w, 3) or velocity.shape != (h, w, 2) or src.dim() != 3
            or src.shape[2] != 3):
        raise ValueError(f"colour {tuple(color.shape)}, velocity "
                         f"{tuple(velocity.shape)}, source {tuple(src.shape)}")
    tile = blue_noise_tile_tensor(color.device)
    sy, sx = noise_shift(frame, row_offset, 0, tile.shape[0])
    cuda_build.require_cuda(color, velocity, src, tile)
    out = torch.empty_like(color)
    f32 = np.float32
    div = f32(float(samples) + 2.0)
    fparams = np.array([intensity, jitter, _frame_speed(delta_time), f32(1) / f32(w),
                        f32(1) / f32(src.shape[0]), div, f32(1) / div], f32)
    # PyTorch on CUDA divides by a host scalar as a product with its
    # float32 reciprocal, on the CPU it divides: the kernel follows the
    # plain route of the tensors' device
    recip = int(color.device.type == "cuda")
    cuda_build.launch("motion_blur_taps", "motion_blur", "re_motion_blur_taps",
                      (5, 10, 1), color,
                      color.data_ptr(), velocity.data_ptr(), tile.data_ptr(),
                      src.data_ptr(), out.data_ptr(), h, w, int(src.shape[0]),
                      int(src.shape[1]), int(row_offset), int(tile.shape[0]), sy, sx,
                      int(samples), recip, fparams.ctypes.data)
    return out


def sweep_cells(frame: int, h: int, w: int, dirs: int, steps: int,
                min_radius: float, max_radius_frac: float):
    """The host cell table of :func:`motion_blur_sweep`, in float32:
    (dy (dirs, steps) int, dx (dirs, steps) int, e_lo (steps,), e_hi
    (steps,), xi). Cell (d, k) reads the frame at (y + dy, x + dx) and
    covers the radii [e_lo[k], e_hi[k]) of direction bin d."""
    f32 = np.float32
    lib = _libm()
    xi = np.mod(f32(frame) * f32(_R2_PHI), f32(1.0))
    bin_w = f32(2.0 * math.pi / dirs)
    r_max = max_radius_frac * float((h * h + w * w) ** 0.5)
    expo = np.arange(steps, dtype=f32) / f32(steps - 1)
    base = f32(r_max / min_radius)
    nodes = f32(min_radius) * np.array(
        [lib.powf(float(base), float(e)) for e in expo], f32)
    edges_mid = np.sqrt(nodes[:-1] * nodes[1:])
    e_lo = np.concatenate([np.zeros(1, f32), edges_mid])
    e_hi = np.concatenate([edges_mid, nodes[-1:]])
    ang = (np.arange(dirs, dtype=f32) + xi) * bin_w
    cos = np.array([lib.cosf(float(a)) for a in ang], f32)[:, None]
    sin = np.array([lib.sinf(float(a)) for a in ang], f32)[:, None]
    dxs = np.round(nodes[None, :] * cos).astype(np.int64)
    dys = np.round(nodes[None, :] * sin).astype(np.int64)
    return dys, dxs, e_lo, e_hi, float(xi)


def motion_blur_sweep(color: torch.Tensor, velocity: torch.Tensor, frame: int,
                      intensity=1.0, jitter=1.0, delta_time=1.0 / 60.0,
                      dirs: int = 16, steps: int = 12,
                      min_radius: float = 0.75,
                      max_radius_frac: float = 0.25, row_offset: int = 0,
                      source: torch.Tensor | None = None) -> torch.Tensor:
    """Direction-binned sweep line integral: the same integral as
    :func:`motion_blur` (`motion_blur.frag:23-42`), the average scene
    colour over the segment ``uv + (jitterOffset +- vel / 2) *
    frameSpeed``. The segment's pixel-space direction picks one of
    ``dirs`` R2-rotated bins per side (+/-); a shared geometric radius
    ladder ``min_radius .. max_radius_frac * diagonal`` cuts [0, r_max)
    into cells, and each pixel weights cell k of its bin by the overlap
    of the cell with its own jittered per-side extent. Out-of-frame taps
    drop and renormalise; the uncovered sliver near the origin plus the
    reference's double-counted centre tap weight the pixel's own colour.

    A row block of a larger frame passes its first row's global index
    ``row_offset`` and the whole frame's colour as ``source`` (the cells
    read it up to ``max_radius_frac`` of the diagonal away); ``color``
    and ``velocity`` are the block's, and the cell table is the
    frame's."""
    h, w = color.shape[:2]
    fh = h if source is None else source.shape[0]
    dev = color.device
    with tracing.span("pass:motion_blur.setup"):
        vel = velocity * float(intensity)
        did_move = (velocity * velocity).sum(-1) > 1e-9
        frame_speed = _frame_speed(delta_time)

        # segment geometry in pixel space
        px = tracing.to_device([float(w), float(fh)], dev, site="motion_blur.px")
        seg = vel * frame_speed * px           # full extent, pixels
        seg_len = torch.sqrt(seg[..., 0] * seg[..., 0] + seg[..., 1] * seg[..., 1])
        half = 0.5 * seg_len
        theta = torch.atan2(seg[..., 1], seg[..., 0])
        # the reference's forward segment shift jitter * vel * noise, along
        # the segment with the r noise channel
        noise = blue_noise_image(h, w, frame, row_offset=row_offset, device=dev)
        j_px = float(jitter) * noise[..., 0] * seg_len
        u_pos = torch.clamp(j_px + half, min=0.0)
        u_neg = torch.clamp(half - j_px, min=0.0)

        dys, dxs, e_lo, e_hi, xi = sweep_cells(frame, fh, w, dirs, steps,
                                               min_radius, max_radius_frac)
        bin_w = float(np.float32(2.0 * math.pi / dirs))
        bin_pos = torch.remainder(torch.round(theta / bin_w - xi), float(dirs))
        bin_neg = torch.remainder(torch.round((theta + math.pi) / bin_w - xi),
                                  float(dirs))

        # the float16 frame (the composer's HalfFloat target) with a ones
        # channel, zero-padded so that every cell is an in-bounds slice
        pad = int(max(np.abs(dys).max(), np.abs(dxs).max()))
        whole = color if source is None else source
        src = torch.cat([whole, torch.ones_like(whole[..., :1])], -1).to(torch.float16)
        src = torch.nn.functional.pad(src, (0, 0, pad, pad, pad, pad))
    with tracing.span("pass:motion_blur.accumulate"):
        acc = accumulate(src, u_pos, u_neg, bin_pos, bin_neg, dys, dxs, e_lo,
                         e_hi, pad, row_offset)

    # centre: the near-origin sliver both sides leave uncovered when the
    # extent is shorter than cell 0, plus the reference's double-counted
    # centre tap (2 of samples + 2, a 2 / 18 fraction of the extent)
    with tracing.span("pass:motion_blur.resolve"):
        r_end = float(e_hi[-1])
        covered = torch.clamp(u_pos, max=r_end) + torch.clamp(u_neg, max=r_end)
        w_center = torch.clamp(u_pos + u_neg - covered, min=0.0) \
            + (u_pos + u_neg) * (2.0 / 18.0) + 1e-6
        rgb = acc[..., :3] + color * w_center[..., None]
        blurred = rgb / (acc[..., 3] + w_center)[..., None]
        return torch.where(did_move[..., None], blurred, color)


def accumulate(src, u_pos, u_neg, bin_pos, bin_neg, dys, dxs, e_lo, e_hi,
               pad: int, row_offset: int = 0) -> torch.Tensor:
    """The accumulate pass of :func:`motion_blur_sweep`: (H, W, 4) float32,
    the weighted rgb sum and the weight sum over the pixel's cells.
    ``src`` is the padded float16 RGB1 frame, ``u_pos``/``u_neg`` and
    ``bin_pos``/``bin_neg`` the (H, W) extents and direction bins of the
    two sides, (``dys``, ``dxs``, ``e_lo``, ``e_hi``) the host cell table,
    ``pad`` the source's padding and ``row_offset`` the block's first
    global row. CUDA tensors launch ``csrc/motion_blur.cu``; CPU tensors
    take :func:`accumulate_plain`."""
    if src.device.type == "cpu":
        return accumulate_plain(src, u_pos, u_neg, bin_pos, bin_neg, dys,
                                dxs, e_lo, e_hi, pad, row_offset)
    return _launch(src, u_pos, u_neg, bin_pos, bin_neg, dys, dxs, e_lo, e_hi,
                   pad, row_offset)


def accumulate_plain(src, u_pos, u_neg, bin_pos, bin_neg, dys, dxs, e_lo,
                     e_hi, pad: int, row_offset: int = 0) -> torch.Tensor:
    """:func:`accumulate` as whole-frame torch ops: every one of the
    ``dirs x steps`` cells is a shifted read of the whole frame, weighted
    per pixel (0 off the pixel's two bins)."""
    h, w = u_pos.shape
    dirs, steps = dys.shape
    dev = u_pos.device
    acc = torch.zeros((h, w, 4), device=dev)   # rgb sum, weight sum
    lo = torch.as_tensor(e_lo, device=dev)[:, None, None]
    hi = torch.as_tensor(e_hi, device=dev)[:, None, None]
    neg_inf = float("-inf")
    for d in range(dirs):
        # each side's extent where that side's bin is d, -inf elsewhere:
        # clamp(min(u, hi) - lo, 0) is then the side's weight of each of
        # the bin's cells (steps, H, W), and 0 off the bin (as the JAX
        # package's weight * (bin == d))
        u_pos_d = torch.where(bin_pos == float(d), u_pos, neg_inf)
        u_neg_d = torch.where(bin_neg == float(d), u_neg, neg_inf)
        wgt = torch.clamp(torch.minimum(u_pos_d, hi) - lo, min=0.0) \
            + torch.clamp(torch.minimum(u_neg_d, hi) - lo, min=0.0)
        for k in range(steps):
            y0, x0 = pad + row_offset + int(dys[d, k]), pad + int(dxs[d, k])
            # acc += cell * weight in one pass, the f16 cell read in place
            acc.addcmul_(src[y0: y0 + h, x0: x0 + w], wgt[k, ..., None])
    return acc


def _launch(src, u_pos, u_neg, bin_pos, bin_neg, dys, dxs, e_lo, e_hi,
            pad: int, row_offset: int = 0) -> torch.Tensor:
    h, w = u_pos.shape
    dirs, steps = dys.shape
    planes = [t.contiguous() for t in (u_pos, u_neg, bin_pos, bin_neg)]
    src = src.contiguous()
    if src.dtype != torch.float16 or src.dim() != 3 or src.shape[2] != 4:
        raise ValueError("the source must be (rows, cols, 4) float16, not "
                         f"{tuple(src.shape)} {src.dtype}")
    cuda_build.require_cuda(*planes, src)
    acc = torch.empty((h, w, 4), dtype=torch.float32, device=src.device)
    offsets = np.concatenate([dys.reshape(-1), dxs.reshape(-1)]).astype(np.int32)
    radii = np.concatenate([e_lo, e_hi]).astype(np.float32)
    cuda_build.launch("motion_blur", "motion_blur", "re_motion_blur", (6, 8, 2), src,
                      *(t.data_ptr() for t in planes), src.data_ptr(), acc.data_ptr(),
                      h, w, int(src.shape[0]), int(src.shape[1]), pad + row_offset,
                      pad, dirs, steps, offsets.ctypes.data, radii.ctypes.data)
    return acc
