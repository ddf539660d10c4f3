#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (realism_effects_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Print the card's name and power limit, turn TF32 off, and build the
   CUDA kernels from ``realism_effects_tpu_torch/csrc`` (nvcc, sm_90a).
2. Hold each kernel against its plain PyTorch version on the card at the
   1920x1080 shapes of the paths, with the stated tolerance, and time
   both with CUDA events (median of 25 launches, L2 flushed before each,
   the card kept busy while the host prepares a launch). Where one
   PyTorch call computes the same function, time it too (``library_ms``;
   the port never calls it). The SSGI kernels (sweep march, bilinear
   prewarp, two-texture Poisson pass) take the inputs they get in frame 5
   of the SSGI path; the raster kernels (z-scan, per-face record fetch)
   those of frame 5 of the flagship path; the multi-target warp and the
   Poisson tap fetch those of frame 1 of the unfused HBAO + Poisson
   route; sharpness frame 1's lit colour; the sweep with one ray and the
   Poisson pass with one RGBA slot those of frame 5 of the SSR + GTAO +
   TAA path. More checks print on their
   own lines: sharpness at C = 4 and on a colour that is a view 4 bytes
   into its storage (exact); the z-scan on a tie-heavy synthetic table at 1080p (0
   winner flips, exact z); both Poisson passes at radius 12, where taps
   leave the kernel's staged halo; the tap fetch at radius 12 against
   ``bundle[iy, ix]`` (exact); the catrom5 warp on a history that is a
   view 4 bytes into its storage, so read with 4-byte loads (exact);
   minmax at r=1 (exact); HBAO's noise
   table against torch's libm (tol 2e-5), HBAO timed at spp 1, 8 and
   32, at spp 40 (two launches with the sums carried) and at a second distance and power (its own noise
   table), both tol 2e-4; the record fetch on both records of the frame,
   the G-buffer's (the entry's numbers) and the velocity's, each exact
   and timed with its library call; the sweep over a 32 x 128 table (in
   shared memory through the opt-in) and a 64 x 304 one (above the
   opt-in limit, read from device memory), both exact; the z-scan's
   alpha variant, every depth-peel pass in one launch, on the 3840 x
   2160 raster of frame 5 of the glTF alpha + MSAA path at its 3 passes
   (the entry's numbers) and at 6 (two chunks, the second after the
   first's floor), each against as many passes of the plain version bit
   for bit, then 3 and 6 passes over the tie-heavy table at 1080p
   (exclusion by id: an excluded winner's duplicate must win the next
   pass). Then the
   cube-map routines, which have no kernel of their own
   (``cube_to_equirect``, ``ggx_prefilter_mips``, ``blur_env(..., 0.5)``
   at a 128 x 256 map), on the card against the CPU with their ms.
   Motion blur's accumulate kernel on the inputs of the flagship's
   frame 3 at 1920x1080 (the entry's numbers) and at 3840x2160, each
   against the plain loop (exact) with the mean cells a pixel reads of
   the loop's dirs x steps, counted from the inputs by a plain reduction.
   SSGI's per-pixel march (both rays of a frame) and motion blur's taps
   on the inputs of frame 3 of the flagship with upstream's per-pixel
   stack (``analytic.flagship_march_composer``), each against its plain
   route (exact), with the share of lanes that hit and of pixels that
   move. Temporal reprojection's prepare and blend kernels (with the
   fetches between them) on the inputs of the flagship's frame 3, SSGI's
   two-slot and TRAA's one-slot reprojections, at 1920x1080 (the
   entries) and 3840x2160, each against the plain route (exact).
3. Run the ten paths at 1920x1080. Through
   ``EffectComposer.render_external`` on analytic buffers (a ground plane
   and a box, plus the flagship's metallic sphere on the SSGI path,
   ray-cast per pixel on the card with the camera orbiting):
   ``HBAOEffect()`` + ``TRAAEffect()`` over 12 frames; ``SSGIEffect()`` +
   ``HBAOEffect()`` + ``TRAAEffect()`` under the flagship's environment
   over 24 frames. Through ``EffectComposer.render`` (the plane, box and
   sphere rasterized and shaded): the flagship stack, ``SSGIEffect()`` +
   ``HBAOEffect()`` + ``MotionBlurEffect()`` + ``TRAAEffect()``, over 24
   frames; the same stack with ``SSGIEffect(trace="march")`` and
   ``MotionBlurEffect(mode="taps")`` over 12 frames (it must launch the
   march and taps kernels and neither sweep); the reference demo's
   stack, ``SSGIEffect()`` ->
   ``ToneMappingEffect()`` -> ``TRAAEffect()`` -> ``SharpnessEffect()`` ->
   ``VignetteEffect()`` -> ``BloomEffect()`` -> ``LUT3DEffect`` (a 32^3
   cube built in code), over 12 frames. Then HBAO + TRAA again over 12
   frames with HBAO and the Poisson denoiser on the JAX package's unfused
   route (``analytic.unfused()``). Then the reference's three other
   exports through ``render``, ``SSREffect()`` -> ``GTAOEffect()`` ->
   ``TAAPass()`` on the flagship scene, over 12 frames with the camera
   still for the first 6 (after 4 warm-up frames) and then one orbit
   step (``analytic.still_then_step``). Then, through ``render``, the
   reference's per-pixel march: ``SSGIEffect(trace="march")`` ->
   ``SMAAEffect()`` on the flagship scene under a cube map (the six faces
   of the flagship's sky, which the composer turns into an equirect),
   and ``SSREffect(trace="march")`` -> ``HBAOEffect()`` -> ``FXAAEffect()``
   under an orthographic camera, 12 frames each. Then a loaded asset
   (``analytic.gltf_alpha_msaa_composer``): the flagship scene with a
   box of material alpha 0.5 and a cutout quad under a checker alpha
   map, written by ``write_glb``, read back by ``load_gltf_asset``, the
   box animated by an ``AnimationMixer``, rendered through ``render`` by
   ``EffectComposer(..., msaa=2, alpha_peels=3)`` with ``HBAOEffect()``
   -> ``TRAAEffect()``, the camera still and then one orbit step, over
   12 frames; it must launch the z-scan's alpha variant 2 times a frame
   (one a raster, every peel in it) and never the opaque z-scan. The launch census
   of ``ops/cuda_build.py`` is cleared just before each path
   and read just after: each path must have launched each of its
   kernels (and the unfused path neither the fused HBAO nor the fused AO
   Poisson kernel, the SSR path neither HBAO, the 2-ray sweep nor the
   2-slot Poisson pass, the march paths neither sweep nor the bilinear
   prewarp, the first six paths no ray march, and no path HBAO's noise-table
   kernel, whose table is built once per setting), and every kernel in
   the ``kernels`` line launches on at least one path. Then a 3-frame run
   of each path at 270x480 must agree with the same composer on the CPU,
   and SMAA and FXAA alone on the card must agree with the CPU over the
   CPU paths' own pre-AA frames (SMAA_ALONE_MAX_TOL, FXAA_ALONE_MAX_TOL).
4. ``[split]``: the split frame (``EffectComposer._build_frame_fn(mesh)``,
   driven through ``render(mesh=...)``) on ``_mesh(torch, 4)``: the
   flagship, the flagship with the march and the taps (both kernels per
   shard) and HBAO + TRAA on the flagship scene at 1920x1080, 3 frames
   each, every frame's image and every leaf of the final state against
   the unsplit frames on the card within SPLIT_TOL (the JAX package's
   bounds, 2e-4 and 5e-4; 0 expected); it prints the differences, each
   stage's placement, the kernels launched in the split run and the host
   ms per frame of both runs, and claims nothing of speed. It is the
   card's one check of row sharding.
5. ``[demo]``: the port's demo (``tools/demo.py``) on the six scenes it
   builds in code (DEMO_RUNS: ``lights`` with ``ssgi,hbao`` + TRAA, point
   lights and the specular sun; ``dynamic`` with ``ssgi,motion_blur`` +
   TAA; ``showcase`` with SSR, GTAO and the finishing stack + SMAA;
   ``traa_test`` with HBAO + FXAA; ``gltf`` with SSGI + MSAA; ``ao`` with
   HBAO + TRAA on the sweep trace), ``main()`` for 12 frames at 1024 x 1024
   (steady ms/frame), then 3 frames at 64 x 64 card against CPU within
   its AA pass's DEMO_BOUNDS (the FXAA path's for FXAA; DEMO_BOUNDS says
   why).
6. ``[bench]``: the port's bench (``realism_effects_tpu_torch/bench.py``)
   at full size, one process a mode: the flagship frame, ``--breakdown``
   (with ``--json``), ``--trace march`` and ``--config 1`` .. ``5``; each
   must exit 0 with its headline record last (BENCH_RUNS: the metric, a
   finite positive value no larger than its median), the breakdown with a
   record a stage and its bytes and the card in its artifact's meta.
7. Print the ``kernels`` JSON line, then the device JSON line last.

The script imports nothing of JAX. It needs the repository beside it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

WIDTH, HEIGHT = 1920, 1080
FRAMES = 24           # SSGI + HBAO + TRAA path and the flagship path
HBAO_TRAA_FRAMES = 12  # both HBAO + TRAA paths and the demo stack
WARMUP = 4            # frames before the timed ones: allocator and clocks
SWEEP_FRAME = 5       # the frame whose SSGI trace / raster feeds the checks
MEM_BW = 3.35e12      # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
F32_RATE = 67e12      # H100 SXM float32 outside the tensor cores, op/s
SPLIT_SHARDS = 4
#: the split frame against the unsplit one: tests/test_parallel.py's
#: bounds for its sharded frame (0 expected: the same kernels on the
#: same values)
SPLIT_TOL = {"HBAO+TRAA": 2e-4, "flagship": 5e-4, "flagship march + taps": 5e-4}
DEMO_FRAMES = 12
DEMO_SIZE = 1024

# HBAO + TRAA against the CPU composer (tests/test_torch_slice.py): max
# 1e-3 (a few pixels on a nearest-texel snap or the Poisson weight
# cut-off flip with one ulp), mean 1e-5.
SLICE_TOL = 1e-3
SLICE_MEAN_TOL = 1e-5
# SSGI + HBAO + TRAA against the CPU composer. The card's atan2, sin,
# exp, log and pow differ from the CPU's by ulps; that moves a few rays
# into the next direction bin or across a hit test, and such a pixel
# takes another GI sample, which the denoiser and TRAA spread to its
# neighbours. So: the largest error, the mean error, and the share of
# pixels off by more than 1e-2 (measured on an H100 at 700 W: max 1.03e-2,
# mean 1.1e-6, one pixel of 129600 off by more than 1e-2).
SSGI_SLICE_MAX_TOL = 5e-2
SSGI_SLICE_MEAN_TOL = 1e-5
SSGI_SLICE_PIX_TOL = 1e-2
SSGI_SLICE_PIX_FRAC = 1e-3
# HBAO + TRAA on the unfused route against the CPU composer. It places
# HBAO's samples and the Poisson taps with ATen's sin, cos, exp and pow,
# whose card and CPU versions differ by ulps, so now and then a sample
# or tap snaps to the next texel and moves its pixel, and through the
# denoiser and TRAA a few around it (measured on an H100 at 700 W: max
# 3.4e-3 on the second of 3 frames, mean 3.2e-7). So: max 1e-2, mean
# 1e-5.
UNFUSED_SLICE_MAX_TOL = 1e-2
# The reference demo's stack through render() against the CPU composer,
# at the flagship's bounds: tone mapping compresses the SSGI differences
# into [0, 1], sharpness (x 1 + s) and bloom spread them again.
# The two paths that end in an AA pass. SMAA and FXAA decide per pixel
# (an edge over a luma threshold, a search that ends where the luma steps
# by its gradient), so an input that differs by an ulp-sized amount on
# the card now and then flips a decision, and that moves the pixel by up
# to its neighbourhood's contrast (up to 5 between neighbours in these
# HDR frames). Before the AA pass both paths agree within the SSGI
# bounds (measured on an H100 at 700 W, 270x480, 3 frames: the march
# with SSGI or SSR max 1.4e-3, at most 3 pixels off by more than 1e-3).
# After SMAA (measured over 6 frames: max 7.3e-2, mean 2.8e-6, share
# over 1e-2 8.5e-5) the SSGI mean and share hold and the max gets
# its own bound. FXAA's searches flip on far more pixels of the ortho
# path's noisy floor (FXAA alone on the raster colour: one pixel a frame;
# after SSR and HBAO, measured over 6 frames: max 0.31, mean 4.8e-5,
# share over 1e-2 1.9e-3), so that path gets its own three bounds.
AA_SLICE_MAX_TOL = 0.5
ORTHO_FXAA_MAX_TOL = 1.0
# Beside those: each AA pass alone on the card over the CPU path's own
# pre-AA frame, so that a fault in the pass shows on its own. Measured on
# an H100 at 700 W: SMAA alone equal to the CPU; FXAA alone max 6.2e-5
# (ATen's card and CPU bilinear blends round the HDR colour apart) and,
# in an earlier run, one flipped search a frame (up to 0.12). So: SMAA
# every pixel within 1e-5; FXAA every pixel within 1e-3 but at most 2
# pixels a frame.
SMAA_ALONE_MAX_TOL = 1e-5
FXAA_ALONE_MAX_TOL = 1e-3
FXAA_ALONE_FLIPS = 2
ORTHO_FXAA_MEAN_TOL = 2e-4
ORTHO_FXAA_PIX_FRAC = 1e-2
# The demo's scenes at 64 x 64, card against CPU, each held to its AA
# pass's bounds. At this size one decision flipped by an ulp is most of
# the mean on its own: the Poisson denoiser's blue-noise angle near a
# multiple of pi/4 puts its diagonal taps at radius 3 on texel edges on
# flat ground, where ATen's CPU and the card's sin/cos differ by an ulp,
# so one tap snaps to the next texel and its pixel moves by up to 0.07
# (1-2.5e-5 of the 64 x 64 mean). Measured on an H100 at 700 W, 3 frames:
# TRAA (lights, ao) max 3.9e-2, mean 2.5e-5, share over 1e-2 7.3e-4; TAA
# (dynamic) max 4.5e-2, mean 1.5e-5, share 2.4e-4; SMAA (showcase) max
# 8.2e-8; MSAA (gltf) max 6.9e-2, mean 2.3e-5, share 7.3e-4. So those
# four take the SMAA path's max (AA_SLICE_MAX_TOL) and the SSGI share,
# with a mean of 5e-5 for the one-tap snap, and FXAA (traa_test: max
# 0.25, mean 1.24e-4, share 4.2e-3) keeps the FXAA path's three bounds.
DEMO_SLICE_MEAN_TOL = 5e-5
DEMO_BOUNDS = {"fxaa": (ORTHO_FXAA_MAX_TOL, ORTHO_FXAA_MEAN_TOL, ORTHO_FXAA_PIX_FRAC)}
DEMO_BOUNDS.update({aa: (AA_SLICE_MAX_TOL, DEMO_SLICE_MEAN_TOL, SSGI_SLICE_PIX_FRAC)
                    for aa in ("traa", "taa", "smaa", "msaa")})

# Operations per pixel of the kernels whose arithmetic rivals their
# bytes, counted from the kernels' source: every add, multiply, compare,
# min/max, division, square root and transcendental is one operation
# (a lower bound: libm's sinf/expf/logf take tens of instructions).
HBAO_OPS_SETUP = 61       # uv, ndc, two transform_points, the basis
HBAO_OPS_SAMPLE = 122     # direction, projection, fetch index, integral
HBAO_OPS_NOISE = 13       # per blue-noise texel: the cosine draw and distance
POISSON_OPS_SETUP = 90    # 3 normal decodes, flatness, noise angle
POISSON_OPS_TAP = 45      # offsets, snap, normal decode, edge weights
POISSON_OPS_TAP_SLOT = 45  # per slot: unpack, logs, luma, age blend
SWEEP_OPS_RAY = 10        # plane loads, bin checks, stores
SWEEP_OPS_STEP = 25       # texel index, bounds, t(s), validity, hit test
BILINEAR_OPS = 12 + 3 * 9  # index and window math, 3 lerps a channel
ZSCAN_OPS = 35            # per (pixel, triangle whose bbox contains its centre)
WARP_MULTI_OPS = 12       # per (target, pixel): clip, window and frame clamps, flag
SHARPNESS_OPS = 14        # per (pixel, channel): 9 adds, 2 fused multiply-adds, max
MB_OPS_CELL = 4           # per cell of a pixel's bins: min, subtract, max, zero test
MB_OPS_READ = 8           # per cell read: 4 fused multiply-adds
MB_BYTES_PIXEL = 40       # u and bin planes 16, its own texel 8, the sums 16
RM_OPS_LANE = 31          # per march lane: step vector, start's projection, results
RM_OPS_STEP = 50          # per step: eased step, projection, texel, view z, hit test
RM_BYTES_LANE = 49        # view position, ray 12 each, random 4, uv 8, hit 12, flag 1
TAPS_OPS_PIXEL = 8        # per taps pixel: its uv and the still test
TAPS_BYTES_PIXEL = 32     # colour (the taps' source) 12, velocity 8, output 12
RP_OPS_PIXEL = 110        # per reprojected pixel and kernel: uv, world position, hit point
RP_OPS_SLOT = 90          # per slot: the fetch's weights, clamp, selects, accumulation
SH_OPS_PIXEL = 40         # per shaded pixel: saturation, MIS, direct light, ray length
SH_OPS_RAY = 160          # per ray: angles, both brdfs' terms, env direction and fetch, fade


def _bound(nbytes: float, ops: float):
    t_bytes = nbytes / MEM_BW * 1e3
    t_ops = ops / F32_RATE * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Median CUDA-event time of ``fn`` over ``iters`` launches. Before
    each: a 64 MiB write pushes the inputs out of the 50 MB L2, and a
    ~1 ms device-side sleep keeps the card busy while the host prepares
    the launch, so the events bracket device work and not host work."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int = 25, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))


class Entries(list):
    """The ``kernels`` line, one dict per kernel check."""

    def add(self, name, source, replaces, err, tol, ms, plain_ms, nbytes,
            ops, library_ms=None):
        bound_ms, bound_by = _bound(nbytes, ops)
        if not err <= tol:
            raise AssertionError(f"{name}: kernel vs plain max abs error "
                                 f"{err} > {tol}")
        self.append(dict(
            name=name, route="cuda",
            source=f"realism_effects_tpu_torch/csrc/{source}",
            replaces=replaces, launches=None, max_abs_err=err, tol=tol,
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms))
        print(f"[kernel] {name}: max_abs_err={err} (tol {tol}) ms={ms} "
              f"plain_ms={plain_ms} bound_ms={bound_ms} ({bound_by}) "
              f"library_ms={library_ms}", flush=True)


def _maxerr(torch, a, b):
    torch.cuda.synchronize()
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------

def check_kernels(torch, analytic, timer, frames, results):
    """The HBAO + TRAA kernels against their plain versions at 1080p."""
    from realism_effects_tpu_torch.core.camera import PerspectiveCamera
    from realism_effects_tpu_torch.core.math3d import floor_int32, uv_grid
    from realism_effects_tpu_torch.ops import (hbao_kernel, poisson_kernel,
                                               stencil, warp)
    from realism_effects_tpu_torch.ops.ao import AOConfig
    from realism_effects_tpu_torch.ops.poisson_denoise import \
        PoissonDenoiseConfig

    h, w = HEIGHT, WIDTH
    gb, vel, color = frames[1]
    _, last_vel, _ = frames[0]
    uv = uv_grid(h, w, "cuda")
    reproj = uv - vel.velocity
    maxerr = lambda a, b: _maxerr(torch, a, b)

    # warp catrom5: the TRAA history fetch (ky=8, kx=30, f16 history)
    hist = torch.cat([color, torch.full_like(color[..., :1], 5.0)], -1)
    hist = hist.to(torch.float16).to(torch.float32)
    x = reproj[..., 0] * w - 0.5
    y = reproj[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    args = (hist, floor_int32(y0), floor_int32(x0), y - y0, x - x0)
    k = warp.window_warp(*args, ky=8, mode="catrom5", kx=30)
    p = warp.window_warp_plain(*args, ky=8, mode="catrom5", kx=30)
    err = max(maxerr(k[0], p[0]), maxerr(k[1], p[1]))
    nbytes = sum(a.nbytes for a in args) + k[0].nbytes + k[1].nbytes
    results.add("warp_catrom5", "warp.cu",
                "realism_effects_tpu/ops/pallas/warp.py:91", err, 1e-6,
                timer(lambda: warp._launch(*args, 8, "catrom5", 30)),
                timer(lambda: warp.window_warp_plain(*args, ky=8, mode="catrom5", kx=30)),
                nbytes, h * w * (4 * 32 + 30))
    # the same history as a view 4 bytes into its storage: 4-byte loads
    hist_off = torch.empty(hist.numel() + 1, device="cuda")[1:].view_as(hist).copy_(hist)
    args_off = (hist_off,) + args[1:]
    k = warp.window_warp(*args_off, ky=8, mode="catrom5", kx=30)
    p = warp.window_warp_plain(*args_off, ky=8, mode="catrom5", kx=30)
    err_off = max(maxerr(k[0], p[0]), maxerr(k[1], p[1]))
    print(f"[check] warp_catrom5 on a texture at a 4-byte offset (data_ptr % 16 = "
          f"{hist_off.data_ptr() % 16}): max abs error {err_off} (tol 0.0), ms="
          f"{timer(lambda: warp._launch(*args_off, 8, 'catrom5', 30))}", flush=True)
    if not err_off <= 0.0:
        raise AssertionError(f"warp_catrom5 at a 4-byte offset: {err_off} > 0.0")

    # warp nearest: the disocclusion probe of (normal, depth)
    nd = torch.cat([last_vel.normal, last_vel.depth[..., None]], -1).contiguous()
    iy = floor_int32(reproj[..., 1] * h)
    ix = floor_int32(reproj[..., 0] * w)
    k = warp.window_warp(nd, iy, ix, ky=8, mode="nearest", kx=30)
    p = warp.window_warp_plain(nd, iy, ix, ky=8, mode="nearest", kx=30)
    err = max(maxerr(k[0], p[0]), maxerr(k[1], p[1]))
    # library yardstick: advanced indexing at the window-clamped texel
    ys = torch.arange(h, device="cuda", dtype=torch.int32)[:, None]
    xs = torch.arange(w, device="cuda", dtype=torch.int32)[None, :]
    li = (ys + torch.clamp(torch.clamp(iy.clamp(-(1 << 20), 1 << 20) - ys, -8, 8),
                           -ys, h - 1 - ys)).long()
    lj = (xs + torch.clamp(torch.clamp(ix, 0, w - 1) - xs, -30, 30)).long()
    if maxerr(nd[li, lj], k[0]) != 0.0:
        raise AssertionError("nearest warp disagrees with tex[iy, ix]")
    nbytes = nd.nbytes + iy.nbytes + ix.nbytes + k[0].nbytes + k[1].nbytes
    results.add("warp_nearest", "warp.cu",
                "realism_effects_tpu/ops/pallas/warp.py:91", err, 1e-6,
                timer(lambda: warp._launch(nd, iy, ix, None, None, 8, "nearest", 30)),
                timer(lambda: warp.window_warp_plain(nd, iy, ix, ky=8, mode="nearest", kx=30)),
                nbytes, h * w * 4 * 2, library_ms=timer(lambda: nd[li, lj]))

    # minmax r=2 over the TRAA input (1% of texels masked by channel 0)
    inp = torch.cat([color, torch.ones_like(color[..., :1])], -1)
    g = torch.Generator(device="cuda").manual_seed(0)
    inp[..., 0][torch.rand(h, w, device="cuda", generator=g) < 0.01] = -1.0
    k = stencil.neighborhood_minmax(inp, 2)
    p = stencil.neighborhood_minmax_plain(inp, 2)
    err = max(maxerr(k[0], p[0]), maxerr(k[1], p[1]))
    # library yardstick: max_pool2d of the +-masked planes (max, -min)
    valid = (inp[..., 0] >= 0)[..., None]
    for_max = torch.where(valid, inp, -1e30).permute(2, 0, 1)[None].contiguous()
    for_min = torch.where(valid, -inp, -1e30).permute(2, 0, 1)[None].contiguous()
    pool = torch.nn.functional.max_pool2d
    lib = lambda: (pool(for_max, 5, 1, 2), pool(for_min, 5, 1, 2))
    if maxerr(lib()[0][0].permute(1, 2, 0), k[1]) != 0.0:
        raise AssertionError("minmax disagrees with max_pool2d")
    results.add("minmax", "stencil.cu",
                "realism_effects_tpu/ops/pallas/stencil.py:180", err, 0.0,
                timer(lambda: stencil._launch(inp, 2)),
                timer(lambda: stencil.neighborhood_minmax_plain(inp, 2)),
                inp.nbytes * 3, h * w * 4 * 25 * 2, library_ms=timer(lib))
    # minmax r=1: the specular texture's second window
    k = stencil.neighborhood_minmax(inp, 1)
    p = stencil.neighborhood_minmax_plain(inp, 1)
    err1 = max(maxerr(k[0], p[0]), maxerr(k[1], p[1]))
    print(f"[check] minmax at r=1: max abs error {err1} (tol 0.0), ms="
          f"{timer(lambda: stencil._launch(inp, 1))}", flush=True)
    if not err1 <= 0.0:
        raise AssertionError(f"minmax at r=1: {err1} > 0.0")

    # HBAO, spp 8, 32 x 32 window, on the frame's depth and normals
    cam = PerspectiveCamera(50, w / h, 0.1, 100)
    analytic.orbit(cam, 1)
    mats = cam.matrices()
    cfg = AOConfig()
    k = hbao_kernel.hbao_fused(gb.depth, gb.normal, mats, 1, cfg)
    p = hbao_kernel.hbao_fused_plain(gb.depth, gb.normal, mats, 1, cfg)
    err = maxerr(k, p)
    tile = 128 * 128 * 4 * 4
    # the noise table (k1, k2, k3, dist) against torch's libm on the card
    noise = hbao_kernel.noise_table("cuda", cfg.distance, cfg.distance_power + 1.0)
    err_noise = maxerr(noise, hbao_kernel.noise_table_plain(
        hbao_kernel.blue_noise_tile_tensor("cuda"), cfg.distance,
        cfg.distance_power + 1.0))
    print(f"[check] hbao noise table vs torch: max abs error {err_noise} (tol 2e-5); "
          f"table kernel launches so far {counters()['hbao_noise']}", flush=True)
    if not err_noise <= 2e-5:
        raise AssertionError(f"hbao noise table: {err_noise} > 2e-5")
    # operations: the pixels in front of the background (a background
    # pixel's AO is 1 whatever its samples) and the noise once a texel
    fg = int((gb.depth < 1.0).sum())
    print(f"[kernel] hbao: {fg} of {h * w} pixels in front of the background",
          flush=True)
    # the cost of a sample: the time at 1, 8 and 32 samples a pixel
    by_spp = {n: timer(lambda: hbao_kernel._launch(
        gb.depth, gb.normal, mats, 1, dataclasses.replace(cfg, spp=n))) for n in (1, 8, 32)}
    print(f"[check] hbao ms by spp: {json.dumps(by_spp)}; a sample "
          f"{(by_spp[32] - by_spp[1]) / 31} ms", flush=True)
    results.add("hbao", "hbao.cu", "realism_effects_tpu/ops/pallas/hbao.py:58",
                err, 2e-4,
                timer(lambda: hbao_kernel._launch(gb.depth, gb.normal, mats, 1, cfg)),
                timer(lambda: hbao_kernel.hbao_fused_plain(gb.depth, gb.normal, mats, 1, cfg)),
                gb.depth.nbytes + gb.normal.nbytes + tile + k.nbytes,
                fg * (HBAO_OPS_SETUP + cfg.spp * HBAO_OPS_SAMPLE)
                + 128 * 128 * HBAO_OPS_NOISE)
    # spp 40: two launches of 32 and 8 samples, the sums carried between;
    # then a second distance and power: its own noise table
    for label, cfg2 in (("spp 40", dataclasses.replace(cfg, spp=40)),
                        ("distance 1.7, power 2.5",
                         dataclasses.replace(cfg, distance=1.7, distance_power=2.5))):
        err2 = maxerr(hbao_kernel._launch(gb.depth, gb.normal, mats, 1, cfg2),
                      hbao_kernel.hbao_fused_plain(gb.depth, gb.normal, mats, 1, cfg2))
        print(f"[check] hbao at {label}: max abs error {err2} (tol 2e-4)", flush=True)
        if not err2 <= 2e-4:
            raise AssertionError(f"hbao at {label}: {err2} > 2e-4")

    # Poisson AO pass: one scalar slot, radius 3
    ao_tex = torch.cat([k[..., None].expand(h, w, 3), torch.zeros_like(k)[..., None]], -1)
    pcfg = PoissonDenoiseConfig()
    bundle, ch = poisson_kernel.pack_bundle([ao_tex], gb, (True,))
    kk = poisson_kernel.poisson_pass_fused([ao_tex], gb, 2, pcfg, scalar_slots=(True,))[0]
    p = poisson_kernel.poisson_pass_plain(bundle, ch, (True,), 2, pcfg)
    err = maxerr(kk, p)
    wide = dataclasses.replace(pcfg, radius=12.0)
    err12 = maxerr(poisson_kernel._launch(bundle, ch, (True,), 2, wide),
                   poisson_kernel.poisson_pass_plain(bundle, ch, (True,), 2, wide))
    print(f"[check] poisson at radius 12 (taps beyond the staged halo): "
          f"max abs error {err12} (tol 5e-4)", flush=True)
    if not err12 <= 5e-4:
        raise AssertionError(f"poisson at radius 12: {err12} > 5e-4")
    results.add("poisson", "poisson.cu",
                "realism_effects_tpu/ops/pallas/poisson.py:126", err, 5e-4,
                timer(lambda: poisson_kernel._launch(bundle, ch, (True,), 2, pcfg)),
                timer(lambda: poisson_kernel.poisson_pass_plain(bundle, ch, (True,), 2, pcfg)),
                bundle.nbytes + tile + p.nbytes,
                h * w * (POISSON_OPS_SETUP + 8 * (POISSON_OPS_TAP + POISSON_OPS_TAP_SLOT)))


def _sweep_entry(torch, timer, results, name, args, planes, table, radii_prev):
    """The sweep's entry on a frame's captured march arguments ``args``:
    every output of each ray held bit for bit; bytes: each input once,
    each output once; operations: the steps this frame's rays walk (to
    their hit, all steps on a miss, none for a ray whose bin is not one
    of the dirs)."""
    from realism_effects_tpu_torch.ops import ssgi_sweep, sweep_kernel

    h, w = HEIGHT, WIDTH
    maxerr = lambda a, b: _maxerr(torch, a, b)
    z_tex, rad, ray_distance, n_rays, dirs, steps = (args[0], args[1], args[6],
                                                     args[7], args[8], args[9])
    k = sweep_kernel.sweep_march(*args)
    p = sweep_kernel.sweep_march_plain(*args)
    err = max(maxerr(a, b) for kr, pr in zip(k, p) for a, b in zip(kr, pr))
    prev_t = torch.tensor(np.asarray(radii_prev), device="cuda")
    tab = torch.tensor(np.asarray(table, np.float32), device="cuda")
    ys = torch.arange(h, device="cuda")[:, None]
    xs = torch.arange(w, device="cuda")[None, :]
    walked = live = warp_steps = warp_live = 0
    for r, (hit, _, s_lo, _, _) in enumerate(p):
        k_len, p2, rwd, _, bin_, s_end = planes[1 + 6 * r: 7 + 6 * r]
        ok_bin = (bin_ >= 0) & (bin_ < dirs) & (bin_ == torch.floor(bin_))
        k_hit = torch.searchsorted(prev_t, s_lo.contiguous()) + 1
        n_walk = torch.where(hit, k_hit, torch.where(ok_bin, steps, 0))
        walked += int(n_walk.sum())
        # live steps (those that reach the depth test) of the walk, and
        # warp-steps (32 pixels of a row) with a live lane
        row0 = torch.where(ok_bin, bin_, 0.0).long() * steps
        for k_ in range(steps):
            e = tab[row0 + k_]
            yy, xx, s_ = ys + e[..., 0].int(), xs + e[..., 1].int(), e[..., 2]
            den = k_len - s_ * rwd
            t_s = s_ * p2 / torch.where(den > ssgi_sweep.EPS, den, 1.0)
            on = ((k_ < n_walk) & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w) &
                  (s_ <= s_end) & (den > ssgi_sweep.EPS) & (t_s >= 0) &
                  (t_s <= ray_distance))
            live += int(on.sum())
            warp_live += int(on.view(h, w // 32, 32).any(-1).sum())
            warp_steps += int((k_ < n_walk).view(h, w // 32, 32).any(-1).sum())
    outs = sum(t.nbytes for kr in k for t in kr)
    nbytes = z_tex.nbytes + rad.nbytes + planes.nbytes + \
        np.asarray(table).nbytes + np.asarray(radii_prev).nbytes + outs
    print(f"[kernel] {name}: {n_rays} ray(s), {walked / (h * w * n_rays):.2f} steps "
          f"a ray of {steps}; hits {[int(r[0].sum()) for r in p]} of {h * w}; live "
          f"steps {live / walked:.3f} of those walked; warp-steps with a live "
          f"lane {warp_live / warp_steps:.3f} of {warp_steps}", flush=True)
    results.add(name, "sweep.cu", "realism_effects_tpu/ops/pallas/sweep.py:84",
                err, 0.0, timer(lambda: sweep_kernel._launch(*args)),
                timer(lambda: sweep_kernel.sweep_march_plain(*args)),
                nbytes, h * w * n_rays * SWEEP_OPS_RAY + walked * SWEEP_OPS_STEP)


def _poisson_rgba_entry(torch, timer, results, name, texs, gb, noise_index, cfg):
    """A Poisson pass over ``texs`` (RGBA slots, no AO slot) against its
    plain version at the tolerance 1e-5 x the largest value (at least 1:
    exact libm work a tap differs by ulps); returns the plain inputs."""
    from realism_effects_tpu_torch.ops import poisson_kernel

    h, w = HEIGHT, WIDTH
    n = len(texs)
    slots = (False,) * n
    bundle, ch = poisson_kernel.pack_bundle(texs, gb, slots)
    k = poisson_kernel.poisson_pass_fused(texs, gb, noise_index, cfg)
    p = poisson_kernel.poisson_pass_plain(bundle, ch, slots, noise_index, cfg)
    err = max(_maxerr(torch, k[s], p[..., 4 * s: 4 * s + 4]) for s in range(n))
    scale = float(p.abs().max())
    print(f"[kernel] {name}: {n} RGBA slot(s), largest value {scale}", flush=True)
    results.add(name, "poisson.cu", "realism_effects_tpu/ops/pallas/poisson.py:126",
                err, 1e-5 * max(scale, 1.0),
                timer(lambda: poisson_kernel._launch(bundle, ch, slots, noise_index, cfg)),
                timer(lambda: poisson_kernel.poisson_pass_plain(
                    bundle, ch, slots, noise_index, cfg)),
                bundle.nbytes + 128 * 128 * 4 * 4 + p.nbytes,
                h * w * (POISSON_OPS_SETUP + 8 * (POISSON_OPS_TAP
                                                  + n * POISSON_OPS_TAP_SLOT)))
    return bundle, ch


def check_ssgi_kernels(torch, analytic, timer, frames, results):
    """The SSGI path's kernels on the inputs they take in frame
    ``SWEEP_FRAME`` of the SSGI + HBAO + TRAA composer at 1080p (after
    that many frames of feedback): the sweep march, the bilinear prewarp
    of last frame's composed output, and the two-texture Poisson pass."""
    from realism_effects_tpu_torch.core.math3d import floor_int32, uv_grid
    from realism_effects_tpu_torch.ops import (poisson_denoise, poisson_kernel,
                                               ssgi_sweep, sweep_kernel, warp)

    h, w = HEIGHT, WIDTH
    maxerr = lambda a, b: _maxerr(torch, a, b)
    comp, cam = analytic.ssgi_hbao_traa_composer(h, w, "cuda")
    analytic.run_frames(comp, cam, frames[:SWEEP_FRAME], range(SWEEP_FRAME))
    accumulated = comp.state("ssgi")["composed"]
    cfg = comp.effects[0].denoise_cfg

    # frame SWEEP_FRAME through the composer, the arguments of its march
    # and of its two-texture Poisson passes recorded on the way
    captured = {"sweep": [], "poisson": []}
    march, ppass = ssgi_sweep.sweep_march, poisson_denoise.poisson_pass_fused

    def record_march(*args, **kw):
        captured["sweep"].append((args, kw))
        return march(*args, **kw)

    def record_pass(textures, gbuffer, noise_index, cfg_, **kw):
        if len(textures) == 2:
            captured["poisson"].append((list(textures), noise_index))
        return ppass(textures, gbuffer, noise_index, cfg_, **kw)

    ssgi_sweep.sweep_march = record_march
    poisson_denoise.poisson_pass_fused = record_pass
    try:
        analytic.run_frames(comp, cam, frames[SWEEP_FRAME:SWEEP_FRAME + 1],
                            [SWEEP_FRAME])
    finally:
        ssgi_sweep.sweep_march = march
        poisson_denoise.poisson_pass_fused = ppass
    del comp
    gb, vel, _ = frames[SWEEP_FRAME]
    (z_tex, rad, planes, table, radii_prev, thickness, ray_distance, n_rays,
     dirs, steps), kw = captured["sweep"][0]
    args = (z_tex, rad, planes, table, radii_prev, thickness, ray_distance,
            n_rays, dirs, steps, kw.get("miss_gi", False))

    # sweep: every output of both rays, bit for bit
    _sweep_entry(torch, timer, results, "sweep", args, planes, table, radii_prev)
    # the same rays over larger tables: 32 x 128 (shared memory through
    # the opt-in) and 64 x 304 (above the opt-in limit: device memory)
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    for d_, s_ in ((32, 128), (64, 304)):
        tab_, prev_ = ssgi_sweep.step_table(SWEEP_FRAME, h, w, d_, s_, 1.5)[:2]
        packed = sweep_kernel.packed_table(tab_, prev_, d_, s_).nbytes
        a_ = args[:3] + (tab_, prev_) + args[5:8] + (d_, s_) + args[10:]
        e_ = max(maxerr(a, b) for kr, pr in zip(sweep_kernel._launch(*a_),
                                               sweep_kernel.sweep_march_plain(*a_))
                 for a, b in zip(kr, pr))
        where = "shared memory" if packed <= optin else "device memory"
        print(f"[check] sweep with a {d_} x {s_} table ({packed} bytes packed, "
              f"opt-in limit {optin}: {where}): max abs error {e_} (tol 0.0)",
              flush=True)
        if not e_ <= 0.0:
            raise AssertionError(f"sweep with a {d_} x {s_} table: {e_} > 0.0")

    # warp bilinear: the prewarp of last frame's output (f16-rounded rgb)
    # to uv - velocity, ky=8, kx=30 (ops/ssgi.py)
    acc16 = accumulated[..., :3].to(torch.float16).to(torch.float32).contiguous()
    pre_uv = uv_grid(h, w, "cuda") - vel.velocity
    x = pre_uv[..., 0] * w - 0.5
    y = pre_uv[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx = torch.where(x0 < 0.0, 0.0, x - x0)
    fy = torch.where(y0 < 0.0, 0.0, y - y0)
    wargs = (acc16, floor_int32(y0), floor_int32(x0), fy, fx)
    k = warp.window_warp(*wargs, ky=8, mode="bilinear", kx=30)
    p = warp.window_warp_plain(*wargs, ky=8, mode="bilinear", kx=30)
    err = max(maxerr(k[0], p[0]), maxerr(k[1], p[1]))
    # library yardstick: grid_sample, bilinear with clamp-to-edge (no
    # window flag)
    nchw = acc16.permute(2, 0, 1)[None].contiguous()
    grid = (pre_uv * 2.0 - 1.0)[None].contiguous()
    lib = lambda: torch.nn.functional.grid_sample(
        nchw, grid, mode="bilinear", padding_mode="border", align_corners=False)
    lib_err = maxerr(lib()[0].permute(1, 2, 0)[k[1]], k[0][k[1]])
    print(f"[kernel] warp_bilinear vs grid_sample where in window: {lib_err}",
          flush=True)
    nbytes = sum(a.nbytes for a in wargs) + k[0].nbytes + k[1].nbytes
    results.add("warp_bilinear", "warp.cu",
                "realism_effects_tpu/ops/pallas/warp.py:91", err, 1e-6,
                timer(lambda: warp._launch(*wargs, 8, "bilinear", 30)),
                timer(lambda: warp.window_warp_plain(*wargs, ky=8, mode="bilinear", kx=30)),
                nbytes, h * w * BILINEAR_OPS, library_ms=timer(lib))

    # Poisson, two RGBA slots (diffuse, specular): the frame's first pass
    texs, noise_index = captured["poisson"][0]
    bundle, ch = _poisson_rgba_entry(torch, timer, results, "poisson_2tex", texs,
                                     gb, noise_index, cfg)
    wide = dataclasses.replace(cfg, radius=12.0)
    p12 = poisson_kernel.poisson_pass_plain(bundle, ch, (False, False), noise_index, wide)
    err12 = maxerr(poisson_kernel._launch(bundle, ch, (False, False), noise_index, wide), p12)
    tol12 = 1e-5 * max(float(p12.abs().max()), 1.0)
    print(f"[check] poisson_2tex at radius 12 (taps beyond the staged halo): "
          f"max abs error {err12} (tol {tol12})", flush=True)
    if not err12 <= tol12:
        raise AssertionError(f"poisson_2tex at radius 12: {err12} > {tol12}")


def check_ssr_kernels(torch, analytic, timer, results):
    """The SSR path's two kernel configurations that no other path runs,
    on the inputs they take in frame SWEEP_FRAME of the SSR + GTAO + TAA
    composer at 1080p: the sweep march with one ray (the specular) and
    the Poisson pass with one RGBA slot."""
    from realism_effects_tpu_torch.ops import poisson_denoise, ssgi_sweep

    comp, cam = analytic.reference_exports_composer(HEIGHT, WIDTH, "cuda")
    drive = exports_driver(analytic, comp, cam, SWEEP_FRAME)
    drive(0, SWEEP_FRAME)
    captured = {"sweep": [], "poisson": []}
    march, ppass = ssgi_sweep.sweep_march, poisson_denoise.poisson_pass_fused

    def record_march(*args, **kw):
        captured["sweep"].append((args, kw))
        return march(*args, **kw)

    def record_pass(textures, gbuffer, noise_index, cfg_, **kw):
        if kw.get("scalar_slots") is None:   # the SSR texture, not GTAO's AO slot
            captured["poisson"].append((list(textures), gbuffer, noise_index, cfg_))
        return ppass(textures, gbuffer, noise_index, cfg_, **kw)

    ssgi_sweep.sweep_march = record_march
    poisson_denoise.poisson_pass_fused = record_pass
    try:
        drive(SWEEP_FRAME, 1)
    finally:
        ssgi_sweep.sweep_march = march
        poisson_denoise.poisson_pass_fused = ppass
    del comp
    (z_tex, rad, planes, table, radii_prev, thickness, ray_distance, n_rays,
     dirs, steps), kw = captured["sweep"][0]
    if n_rays != 1:
        raise AssertionError(f"the SSR path traced {n_rays} rays, not 1")
    args = (z_tex, rad, planes, table, radii_prev, thickness, ray_distance,
            n_rays, dirs, steps, kw.get("miss_gi", False))
    _sweep_entry(torch, timer, results, "sweep_1ray", args, planes, table, radii_prev)
    texs, gb, noise_index, cfg = captured["poisson"][0]
    if len(texs) != 1:
        raise AssertionError(f"the SSR pass denoised {len(texs)} textures, not 1")
    _poisson_rgba_entry(torch, timer, results, "poisson_1tex", texs, gb,
                        noise_index, cfg)


def check_unfused_kernels(torch, analytic, timer, frames, results):
    """The kernels of the unfused HBAO + Poisson route on the inputs they
    take in frame 1 of the HBAO + TRAA path (the multi-target warp of
    HBAO's 8 depth taps, the tap fetch of the AO denoise pass's 5-slot
    bundle), and sharpness on frame 1's lit colour with s = 1."""
    from realism_effects_tpu_torch.core.camera import PerspectiveCamera
    from realism_effects_tpu_torch.ops import (ao, poisson_denoise, poisson_taps,
                                               stencil, warp)

    h, w = HEIGHT, WIDTH
    maxerr = lambda a, b: _maxerr(torch, a, b)
    gb, _, color = frames[1]
    cam = PerspectiveCamera(50, w / h, 0.1, 100)
    analytic.orbit(cam, 1)
    captured = {}
    multi, taps = ao.window_warp_multi, poisson_denoise.poisson_taps

    def record(name, fn):
        def run(*args, **kw):
            captured.setdefault(name, (args, kw))
            return fn(*args, **kw)
        return run

    ao.window_warp_multi = record("multi", multi)
    poisson_denoise.poisson_taps = record("taps", taps)
    try:
        with analytic.unfused():
            normal, ao_plane = ao.hbao(gb.depth, gb.normal, cam.matrices(), 1,
                                       ao.AOConfig())
            poisson_denoise.poisson_denoise_ao(ao_plane, normal, gb, 1,
                                               poisson_denoise.PoissonDenoiseConfig())
            # the same pass at radius 12: taps beyond a tile's neighbourhood
            poisson_denoise.poisson_taps = record("taps12", taps)
            poisson_denoise.poisson_denoise_ao(
                ao_plane, normal, gb, 1,
                poisson_denoise.PoissonDenoiseConfig(radius=12.0))
    finally:
        ao.window_warp_multi, poisson_denoise.poisson_taps = multi, taps

    # multi-target warp: values and flags, bit for bit
    (depth, ty, tx), kw = captured["multi"]
    ky, kx = kw["ky"], kw["kx"]
    k = warp.window_warp_multi(depth, ty, tx, ky, kx)
    p = warp.window_warp_multi_plain(depth, ty, tx, ky, kx)
    if not torch.equal(k[1], p[1]):
        raise AssertionError("warp_multi: in-window flags differ from the plain version")
    err = maxerr(k[0], p[0])
    # library yardstick: advanced indexing at the window-clamped texels
    lim = 1 << 20
    ys = torch.arange(h, device="cuda", dtype=torch.int32)[:, None]
    xs = torch.arange(w, device="cuda", dtype=torch.int32)[None, :]
    dy = torch.clamp(torch.clamp(ty.clamp(-lim, lim) - ys, -ky, ky), -ys, h - 1 - ys)
    li = (ys + torch.clamp(dy, -ky, ky)).long()
    lj = (xs + torch.clamp(torch.clamp(tx.clamp(-lim, lim), 0, w - 1) - xs, -kx, kx)).long()
    if maxerr(depth[li, lj], k[0]) != 0.0:
        raise AssertionError("warp_multi disagrees with tex[iy, ix]")
    n = ty.shape[0]
    results.add("warp_multi", "warp.cu", "realism_effects_tpu/ops/pallas/warp.py:365",
                err, 0.0, timer(lambda: warp._launch_multi(depth, ty, tx, ky, kx)),
                timer(lambda: warp.window_warp_multi_plain(depth, ty, tx, ky, kx)),
                depth.nbytes + ty.nbytes + tx.nbytes + k[0].nbytes + k[1].nbytes,
                n * h * w * WARP_MULTI_OPS, library_ms=timer(lambda: depth[li, lj]))

    # Poisson tap fetch: the AO pass's bundle at its 8 tap texels
    (bundle, iy, ix), _ = captured["taps"]
    k = poisson_taps.poisson_taps(bundle, iy, ix)
    err = maxerr(k, poisson_taps.poisson_taps_plain(bundle, iy, ix))
    liy, lix = iy.long(), ix.long()   # already clamped into the frame
    if maxerr(bundle[liy, lix], k) != 0.0:
        raise AssertionError("poisson_taps disagrees with bundle[iy, ix]")
    print(f"[kernel] poisson_taps: {iy.shape[0]} taps, bundle {tuple(bundle.shape)}",
          flush=True)
    (b12, iy12, ix12), _ = captured["taps12"]
    k12 = poisson_taps.poisson_taps(b12, iy12, ix12)
    reach = [int((iy12 - torch.arange(h, device="cuda")[:, None]).abs().max()),
             int((ix12 - torch.arange(w, device="cuda")[None, :]).abs().max())]
    err12 = maxerr(k12, b12[iy12.long(), ix12.long()])
    print(f"[check] poisson_taps at radius 12 (reach {reach[0]} rows, {reach[1]} "
          f"columns): max abs error against bundle[iy, ix] {err12} (tol 0.0), ms="
          f"{timer(lambda: poisson_taps._launch(b12, iy12, ix12))}", flush=True)
    if not err12 <= 0.0:
        raise AssertionError(f"poisson_taps at radius 12: {err12} > 0.0")
    results.add("poisson_taps", "taps.cu",
                "realism_effects_tpu/ops/pallas/poisson_taps.py:59", err, 0.0,
                timer(lambda: poisson_taps._launch(bundle, iy, ix)),
                timer(lambda: poisson_taps.poisson_taps_plain(bundle, iy, ix)),
                bundle.nbytes + iy.nbytes + ix.nbytes + k.nbytes, 0,
                library_ms=timer(lambda: bundle[liy, lix]))

    # sharpness, s = 1, on the lit colour (no one library call computes
    # the edge-replicated blur, the unsharp mask and the clamp)
    k = stencil.sharpness_3x3(color, 1.0)
    err = maxerr(k, stencil.sharpness_3x3_plain(color, 1.0))
    results.add("sharpness", "stencil.cu", "realism_effects_tpu/ops/pallas/stencil.py:139",
                err, 0.0, timer(lambda: stencil._launch_sharpness(color, 1.0)),
                timer(lambda: stencil.sharpness_3x3_plain(color, 1.0)),
                color.nbytes + k.nbytes, h * w * 3 * SHARPNESS_OPS)
    # C = 4 (the lit colour and its luma), and the colour as a view 4
    # bytes into its storage (each float loaded and stored on its own)
    color4 = torch.cat([color, color.mean(-1, keepdim=True)], -1)
    color_off = torch.empty(color.numel() + 1, device="cuda")[1:].view_as(color).copy_(color)
    for label, img in (("C = 4", color4), (
            f"at a 4-byte offset (data_ptr % 16 = {color_off.data_ptr() % 16})", color_off)):
        e_ = maxerr(stencil._launch_sharpness(img, 1.0), stencil.sharpness_3x3_plain(img, 1.0))
        bound_ms, _ = _bound(2 * img.nbytes, 0)
        print(f"[check] sharpness {label}: max abs error {e_} (tol 0.0), ms="
              f"{timer(lambda: stencil._launch_sharpness(img, 1.0))} bound_ms={bound_ms}",
              flush=True)
        if not e_ <= 0.0:
            raise AssertionError(f"sharpness {label}: {e_} > 0.0")


def _zscan_ops(tab, h, w):
    """Operations any z-scan needs on ``tab``, whatever its blocks:
    ZSCAN_OPS per (in-frame pixel, triangle whose bbox contains the
    pixel's centre)."""
    import torch

    def axis(lo, hi, n):   # pixel centres i + 0.5 in [lo, hi], 0 <= i < n
        first = torch.clamp(torch.ceil(lo - 0.5), min=0.0)
        last = torch.clamp(torch.floor(hi - 0.5), max=n - 1.0)
        return torch.clamp(last - first + 1.0, min=0.0)

    pix = axis(tab[:, 19], tab[:, 20], h) * axis(tab[:, 21], tab[:, 22], w)
    return ZSCAN_OPS * float(pix.sum())


def tie_table(torch, h, w, seed=0, device="cuda"):
    """A tie-heavy z-scan table at (h, w): 1500 scattered triangles (2 to
    150 pixels across, both windings, mixed w) and a shuffled duplicate
    of each, so every covered pixel of a triangle ties with its copy and
    the lower id must win, plus 700 small triangles inside one 16 x 16
    pixel square (more than a round of the kernel's binning holds).
    3700 triangles in all, made with numpy from ``seed``."""
    from realism_effects_tpu_torch.ops import raster_kernel

    rng = np.random.default_rng(seed)

    def scatter(n, lo, hi, size):
        centre = rng.uniform(lo, hi, (n, 1, 2))
        return centre + rng.normal(size=(n, 3, 2)) * size[:, None, None]

    verts = np.concatenate([
        scatter(1500, (0, 0), (w, h), rng.uniform(1, 75, 1500)),
        scatter(700, (200, 100), (212, 112), rng.uniform(0.5, 2, 700))])
    n = verts.shape[0]
    tri_w = rng.uniform(0.5, 2.0, (n, 3))
    tri_z = rng.uniform(-0.95, 0.95, (n, 3)) * tri_w
    x, y = verts[..., 0], verts[..., 1]
    nxt, nxt2 = [1, 2, 0], [2, 0, 1]
    a = y[:, nxt] - y[:, nxt2]
    b = x[:, nxt2] - x[:, nxt]
    c = x[:, nxt] * y[:, nxt2] - x[:, nxt2] * y[:, nxt]
    t = lambda v, dt=torch.float32: torch.tensor(v, dtype=dt, device=device)
    tab = raster_kernel.zscan_table(
        t(np.stack([a, b, c], -1)), t(tri_z), t(tri_w),
        t(np.where(c.sum(1) >= 0, 1.0, -1.0)), t(np.ones(n, bool), torch.bool),
        t(np.stack([x.min(1), x.max(1), y.min(1), y.max(1)], -1)))
    dup = torch.tensor(rng.permutation(1500), device=device)
    return torch.cat([tab[:1500], tab[dup], tab[1500:]])


def check_raster_kernels(torch, analytic, timer, results):
    """The raster's kernels on the inputs they take in frame SWEEP_FRAME
    of the flagship composer at 1080p: the z-scan on the G-buffer pass's
    triangle table, the record fetch on the G-buffer and velocity
    records."""
    from realism_effects_tpu_torch.ops import raster_kernel, table_kernel
    from realism_effects_tpu_torch.scene import rasterizer

    h, w = HEIGHT, WIDTH
    maxerr = lambda a, b: _maxerr(torch, a, b)
    comp, cam = analytic.flagship_composer(h, w, "cuda")
    analytic.render_frames(comp, cam, range(SWEEP_FRAME))
    captured = {"zscan": [], "lookup": []}
    visibility, lookup = rasterizer.zscan_visibility, rasterizer.face_lookup

    def record_visibility(*args):
        tab = raster_kernel.zscan_table(*args[:6])
        captured["zscan"].append(tab)
        return raster_kernel.zscan(tab, *args[6:])

    rasterizer.zscan_visibility = record_visibility
    rasterizer.face_lookup = lambda t, i: captured["lookup"].append((t, i)) or lookup(t, i)
    try:
        analytic.render_frames(comp, cam, [SWEEP_FRAME])
    finally:
        rasterizer.zscan_visibility, rasterizer.face_lookup = visibility, lookup
    del comp

    # z-scan: the G-buffer pass's table (the first of the frame)
    tab = captured["zscan"][0]
    ids_k, z_k = raster_kernel.zscan(tab, h, w)
    ids_p, z_p = raster_kernel.zscan_plain(tab, h, w)
    flips = int((ids_k != ids_p).sum())
    both = (ids_k == ids_p) & (ids_k >= 0)   # z is +inf where none
    err = maxerr(torch.where(both, z_k, 0.0), torch.where(both, z_p, 0.0))
    print(f"[kernel] zscan: {tab.shape[0]} triangles, winner flips {flips} of "
          f"{h * w}, covered {int((ids_k >= 0).sum())}", flush=True)
    if flips:
        raise AssertionError(f"zscan: {flips} winner flips against the plain version")
    tie = tie_table(torch, h, w)
    ids_t, z_t = raster_kernel._launch(tie, h, w)
    ids_tp, z_tp = raster_kernel.zscan_plain(tie, h, w)
    tie_flips = int((ids_t != ids_tp).sum())
    tie_err = maxerr(torch.where(ids_tp >= 0, z_t, 0.0), torch.where(ids_tp >= 0, z_tp, 0.0))
    print(f"[check] zscan on the tie-heavy table: {tie.shape[0]} triangles, winner "
          f"flips {tie_flips}, max z error {tie_err}, covered "
          f"{int((ids_tp >= 0).sum())}, won by a duplicate "
          f"{int(((ids_tp >= 1500) & (ids_tp < 3000)).sum())}", flush=True)
    if tie_flips or tie_err != 0.0:
        raise AssertionError("zscan disagrees with its plain version on the tie-heavy table")
    results.add("zscan", "raster.cu", "realism_effects_tpu/ops/pallas/raster.py:67",
                err, 0.0, timer(lambda: raster_kernel._launch(tab, h, w)),
                timer(lambda: raster_kernel.zscan_plain(tab, h, w)),
                tab.nbytes + z_k.nbytes + ids_k.nbytes, _zscan_ops(tab, h, w))

    # record fetch: the G-buffer record (the entry's numbers) and the
    # velocity record, each exact and each timed with its library call
    records = []
    for t, i in captured["lookup"][:2]:
        k = table_kernel.face_lookup(t, i)
        err = maxerr(k, table_kernel.face_lookup_plain(t, i))
        r, l = table_kernel._indices(t, i)
        if maxerr(t[r, l], k) != 0.0:
            raise AssertionError("lookup disagrees with table[r, l]")
        bound_ms, bound_by = _bound(t.nbytes + i.nbytes + k.nbytes, 0)
        rec = dict(k=t.shape[-1], max_abs_err=err,
                   ms=timer(lambda: table_kernel._launch(t, i)),
                   plain_ms=timer(lambda: table_kernel.face_lookup_plain(t, i)),
                   bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=timer(lambda: t[r, l]))
        print(f"[kernel] lookup, {rec['k']}-float record: {json.dumps(rec)}", flush=True)
        if not err <= 0.0:
            raise AssertionError(f"lookup, {rec['k']}-float record: {err} > 0.0")
        records.append(rec)
    (gtab, gids), _ = captured["lookup"][:2]
    g = records[0]
    results.add("lookup", "table.cu", "realism_effects_tpu/ops/pallas/table.py:44",
                g["max_abs_err"], 0.0, g["ms"], g["plain_ms"],
                gtab.nbytes + gids.nbytes + gids.numel() * gtab.shape[-1] * 4, 0,
                library_ms=g["library_ms"])
    results[-1]["records"] = records


def _zscan_peels_bytes(tab, h, w, passes):
    """Bytes the alpha variant must move: the table and the alpha (4 B a
    triangle), the dither (4 B a pixel) and the ``passes`` planes of ids
    and z (8 B a pixel each)."""
    return tab.nbytes + 4 * tab.shape[0] + h * w * (4 + 8 * passes)


def _peels_off(torch, got, want):
    """(winner flips, max abs z error where the plain version has a
    winner, z values whose bits differ) of the alpha variant's planes
    against the plain ones."""
    (ids_k, z_k), (ids_p, z_p) = got, want
    flips = int((ids_k != ids_p).sum())
    won = ids_p >= 0
    err = _maxerr(torch, torch.where(won, z_k, 0.0), torch.where(won, z_p, 0.0))
    return flips, err, int((z_k.view(torch.int32) != z_p.view(torch.int32)).sum())


def check_alpha_kernels(torch, analytic, timer, results):
    """The z-scan's alpha variant, every peel pass in one launch, on the
    inputs of frame SWEEP_FRAME of the glTF alpha + MSAA path at 1920 x
    1080 (a 3840 x 2160 raster; the camera still since frame 0, so the
    soft law): the G-buffer raster's call with its 3 passes (the entry's
    numbers) and the same inputs at 6 passes (two chunks, the second
    after the first's floor), each held to as many passes of the plain
    version (winner flips and z) and timed with it; then 3 and 6 passes
    over the tie-heavy table at 1080p, where an excluded winner's
    duplicate ties its z and must win the next pass (exclusion is by
    id)."""
    from realism_effects_tpu_torch.ops import raster_kernel
    from realism_effects_tpu_torch.scene import rasterizer

    comp, cam, mixer = analytic.gltf_alpha_msaa_composer(HEIGHT, WIDTH, "cuda")
    steps = analytic.still_then_step(0, SWEEP_FRAME + 1, SWEEP_FRAME + 1)
    analytic.render_frames(comp, cam, steps[:SWEEP_FRAME], mixer)
    captured = []
    real = rasterizer.zscan_alpha_peels

    def record(*args):
        captured.append(args)
        return real(*args)

    rasterizer.zscan_alpha_peels = record
    try:
        analytic.render_frames(comp, cam, steps[SWEEP_FRAME:], mixer)
    finally:
        rasterizer.zscan_alpha_peels = real
    del comp
    tab, h, w, alpha, dither, cnmf, passes = captured[0]
    print(f"[kernel] zscan_peels: {len(captured)} calls in frame {SWEEP_FRAME} "
          f"(G-buffer and velocity rasters), {passes} passes, cnmf {cnmf}", flush=True)
    runs = []
    for p in (passes, 6):
        got = raster_kernel._launch_peels(tab, h, w, alpha, dither, cnmf, p)
        want = raster_kernel.zscan_alpha_peels_plain(tab, h, w, alpha, dither, cnmf, p)
        flips, err, bits = _peels_off(torch, got, want)
        bound_ms, bound_by = _bound(_zscan_peels_bytes(tab, h, w, p), _zscan_ops(tab, h, w))
        rec = dict(passes=p, raster=[h, w], triangles=tab.shape[0], winner_flips=flips,
                   max_abs_err=err, z_bits_off=bits,
                   ms=timer(lambda: raster_kernel._launch_peels(
                       tab, h, w, alpha, dither, cnmf, p)),
                   plain_ms=(timer(lambda: raster_kernel.zscan_alpha_peels_plain(
                       tab, h, w, alpha, dither, cnmf, p), iters=5, warmup=1)
                       if p == passes else None),
                   bound_ms=bound_ms, bound_by=bound_by,
                   covered_by_plane=[int((want[0][i] >= 0).sum()) for i in range(p)])
        print(f"[kernel] zscan_peels, {p} passes: {json.dumps(rec)}", flush=True)
        if flips or err != 0.0 or bits:
            raise AssertionError(f"zscan_peels with {p} passes disagrees with "
                                 f"{p} passes of the plain version")
        runs.append(rec)
        del got, want

    th, tw = HEIGHT, WIDTH
    tie = tie_table(torch, th, tw)
    # alpha 0.4 on a third of the triangles, drawn from the row's bits, so
    # a triangle and its duplicate share it
    pick = tie.view(torch.int32)[:, :9].sum(1).remainder(3)
    tie_alpha = torch.where(pick == 0, 0.4, 1.0)
    tie_dither = torch.rand((th, tw), generator=torch.Generator("cuda").manual_seed(0),
                            device="cuda")
    for p in (3, 6):
        got = raster_kernel._launch_peels(tie, th, tw, tie_alpha, tie_dither, 3.0, p)
        want = raster_kernel.zscan_alpha_peels_plain(tie, th, tw, tie_alpha, tie_dither,
                                                     3.0, p)
        flips, err, bits = _peels_off(torch, got, want)
        dup_wins = int(((want[0][1] >= 1500) & (want[0][1] < 3000)).sum())
        print(f"[check] zscan_peels on the tie-heavy table, {p} passes at cnmf 3: "
              f"winner flips {flips}, max z error {err}, z values off {bits}, "
              f"second pass won by a duplicate {dup_wins}", flush=True)
        if flips or err != 0.0 or bits or dup_wins == 0:
            raise AssertionError(f"zscan_peels with {p} passes disagrees with its "
                                 "plain version on the tie-heavy table")
    g = runs[0]
    results.add("zscan_peels", "raster.cu",
                "realism_effects_tpu/scene/rasterizer.py:232-295,334-345",
                g["max_abs_err"], 0.0, g["ms"], g["plain_ms"],
                _zscan_peels_bytes(tab, h, w, passes), _zscan_ops(tab, h, w))
    results[-1]["runs"] = runs


def mb_cells_read(torch, u_pos, u_neg, bin_pos, bin_neg, e_lo, e_hi, dirs):
    """(H, W) cells of nonzero weight a pixel has, so reads in the
    accumulate kernel: a plain reduction over the whole cell ladder."""
    dev = u_pos.device
    lo = torch.as_tensor(e_lo, device=dev)[:, None, None]
    hi = torch.as_tensor(e_hi, device=dev)[:, None, None]
    wp = torch.clamp(torch.minimum(u_pos, hi) - lo, min=0.0)
    wn = torch.clamp(torch.minimum(u_neg, hi) - lo, min=0.0)
    on = lambda b: (b >= 0) & (b < dirs) & (b == torch.round(b))
    same = on(bin_pos) & (bin_pos == bin_neg)
    apart = (wp != 0).sum(0) * on(bin_pos) + (wn != 0).sum(0) * on(bin_neg)
    return torch.where(same, (wp + wn != 0).sum(0), apart)


def check_motion_blur_kernel(torch, analytic, timer, results):
    """Motion blur's accumulate kernel against the plain loop on the
    inputs of the flagship's frame 3 at 1920x1080 (the entry) and
    3840x2160 (a ``[kernel]`` line)."""
    from realism_effects_tpu_torch.ops import motion_blur

    for h, w in ((HEIGHT, WIDTH), (2160, 3840)):
        comp, cam = analytic.flagship_composer(h, w, "cuda")
        seen = []
        real = motion_blur._launch

        def record(*args):
            seen.append(args)
            return real(*args)

        motion_blur._launch = record
        try:
            analytic.render_frames(comp, cam, range(4))
        finally:
            motion_blur._launch = real
        del comp
        args = seen[-1]
        u_pos, u_neg, bin_pos, bin_neg, dys, dxs, e_lo, e_hi = args[1:9]
        dirs, steps = dys.shape
        got = motion_blur._launch(*args)
        want = motion_blur.accumulate_plain(*args)
        err = _maxerr(torch, got, want)
        cells = mb_cells_read(torch, u_pos, u_neg, bin_pos, bin_neg, e_lo, e_hi,
                              dirs).float()
        mean_cells = float(cells.mean())
        walked = float((steps * (1 + (bin_pos != bin_neg))).float().mean())
        nbytes = MB_BYTES_PIXEL * h * w
        ops = h * w * (walked * MB_OPS_CELL + mean_cells * MB_OPS_READ)
        ms = timer(lambda: motion_blur._launch(*args))
        plain_ms = timer(lambda: motion_blur.accumulate_plain(*args))
        print(f"[kernel] motion_blur at {w}x{h}: mean cells read a pixel "
              f"{mean_cells} of {dirs * steps} (moving pixels "
              f"{float((cells > 0).float().mean())} of all, their mean "
              f"{float(cells[cells > 0].mean())}); acc max {float(want.abs().max())}",
              flush=True)
        if (h, w) == (HEIGHT, WIDTH):
            results.add("motion_blur", "motion_blur.cu",
                        "none (ops/motion_blur.py accumulate_plain)", err, 0.0,
                        ms, plain_ms, nbytes, ops)
            results[-1]["mean_cells_read"] = mean_cells
        else:
            bound_ms, bound_by = _bound(nbytes, ops)
            print(f"[kernel] motion_blur at {w}x{h}: max_abs_err={err} (tol 0.0) "
                  f"ms={ms} plain_ms={plain_ms} bound_ms={bound_ms} ({bound_by})",
                  flush=True)
            if not err <= 0.0:
                raise AssertionError(f"motion_blur at {w}x{h}: kernel vs plain "
                                     f"max abs error {err} > 0.0")


def march_bytes_ops(h, w, dh, dw, steps):
    """A march launch's least bytes and operations (``port_bench/kernels/
    ray_march_kernel.py``): a lane stops at its hit, so only its first
    step is work every lane must do."""
    lanes = h * w
    return (RM_BYTES_LANE * lanes + 4 * dh * dw,
            lanes * (RM_OPS_LANE + (RM_OPS_STEP if steps > 1 else 0)))


def check_march_taps_kernels(torch, analytic, timer, results):
    """SSGI's per-pixel march (both rays of a frame) and motion blur's
    taps against their plain routes on the inputs of frame 3 of the
    flagship with upstream's per-pixel stack at 1920x1080: bit for bit,
    with the share of lanes that hit and the mean steps a lane walks."""
    from realism_effects_tpu_torch.ops import march_kernel, motion_blur, ssgi

    comp, cam = analytic.flagship_march_composer(HEIGHT, WIDTH, "cuda")
    seen = {"march": [], "taps": []}
    real_march, real_taps = march_kernel.launch, motion_blur._launch_taps

    def record(kind, real):
        def run(*args):
            seen[kind].append(args)
            return real(*args)
        return run

    march_kernel.launch = record("march", real_march)
    motion_blur._launch_taps = record("taps", real_taps)
    try:
        analytic.render_frames(comp, cam, range(4))
    finally:
        march_kernel.launch, motion_blur._launch_taps = real_march, real_taps
    cfg = comp.effects[0].cfg
    del comp
    rays = seen["march"][-2:]
    got = [march_kernel.launch(*a) for a in rays]
    want = [ssgi.view_space_ray_march_plain(*a[:7], cfg) for a in rays]
    err = max(_maxerr(torch, x, y) for g, w_ in zip(got, want) for x, y in zip(g, w_))
    hit = [float((~w_[2]).float().mean()) for w_ in want]
    nbytes = ops = 0
    for a in rays:
        b, o = march_bytes_ops(HEIGHT, WIDTH, *a[2].shape, cfg.steps)
        nbytes, ops = nbytes + b, ops + o
    ms = timer(lambda: [march_kernel.launch(*a) for a in rays])
    plain_ms = timer(lambda: [ssgi.view_space_ray_march_plain(*a[:7], cfg) for a in rays])
    print(f"[kernel] ray_march: share of lanes that hit, by ray {hit}", flush=True)
    results.add("ray_march", "sweep.cu",
                "none (ops/ssgi.py view_space_ray_march_plain, both rays)", err, 0.0,
                ms, plain_ms, nbytes, ops)
    results[-1]["hit_share"] = hit

    args = seen["taps"][-1]
    got = motion_blur._launch_taps(*args)
    want = motion_blur.motion_blur_plain(*args)
    err = _maxerr(torch, got, want)
    vel = args[1]
    moving = float(((vel * vel).sum(-1) > 1e-9).float().mean())
    nbytes = TAPS_BYTES_PIXEL * HEIGHT * WIDTH + 128 * 128 * 16
    ms = timer(lambda: motion_blur._launch_taps(*args))
    plain_ms = timer(lambda: motion_blur.motion_blur_plain(*args))
    print(f"[kernel] motion_blur_taps: share of pixels that move {moving}", flush=True)
    results.add("motion_blur_taps", "motion_blur.cu",
                "none (ops/motion_blur.py motion_blur_plain)", err, 0.0, ms, plain_ms,
                nbytes, TAPS_OPS_PIXEL * HEIGHT * WIDTH)
    results[-1]["moving_share"] = moving


def reproject_bytes(slots, spec, ray, rough):
    """The reprojection kernels' least bytes a pixel, prepare and blend
    together (``csrc/reproject.cu``): both read the velocity buffer (24);
    the prepare kernel the last normal and depth (16), the ray length
    (``ray``, 4) and each slot's history (16), and writes the packed
    normal and depth (16), 8 a nearest probe and 32 a slot (targets,
    fractions, history16); the blend reads the ray length, the roughness
    (``rough``, 4), 17 a probe and a slot's input, fetch, one clamp box
    and output (80)."""
    probes = 2 if spec else 1
    return (56 + 4 * ray + 8 * probes + 48 * slots) + (
        24 + 4 * ray + 4 * rough + 17 * probes + 80 * slots)


def check_reproject_kernels(torch, analytic, timer, results):
    """Temporal reprojection's prepare and blend kernels on the inputs of
    the flagship's frame 3, SSGI's two-slot and TRAA's one-slot
    reprojections, at 1920x1080 (the entries) and 3840x2160 (``[kernel]``
    lines): the kernels' route (prepare, the fetches, blend) against the
    plain route (exact); ms is the two kernels' (each timed alone on the
    arguments they took), with the whole route's ms beside it."""
    from realism_effects_tpu_torch.effects import ssgi as ssgi_effect
    from realism_effects_tpu_torch.effects import traa as traa_effect
    from realism_effects_tpu_torch.ops import reproject_kernel, temporal_reproject

    plain = temporal_reproject.temporal_reproject_plain
    for h, w in ((HEIGHT, WIDTH), (2160, 3840)):
        comp, cam = analytic.flagship_composer(h, w, "cuda")
        seen = {}
        real = {m: m.temporal_reproject for m in (ssgi_effect, traa_effect)}

        def record(name, fn):
            def run(*args, **kw):
                seen[name] = (args, kw)
                return fn(*args, **kw)
            return run

        ssgi_effect.temporal_reproject = record("reproject_2slot", real[ssgi_effect])
        traa_effect.temporal_reproject = record("reproject_1slot", real[traa_effect])
        try:
            analytic.render_frames(comp, cam, range(4))
        finally:
            for m, fn in real.items():
                m.temporal_reproject = fn
        del comp
        for name, (args, kw) in seen.items():
            launched = []
            launch = reproject_kernel._launch
            # each launch's planes as they were then (the route lets the
            # prepare kernel's outputs go before the blend)
            reproject_kernel._launch = lambda stage, planes, *rest: (
                launched.append((stage, dict(planes), *rest)) or launch(stage, planes, *rest))
            try:
                got = reproject_kernel.reproject(*args, **kw)
            finally:
                reproject_kernel._launch = launch
            want = plain(*args, **kw)
            err = max(_maxerr(torch, g, w_) for g, w_ in zip(got, want, strict=True))
            (stage0, planes0, *rest0), (stage1, planes1, *rest1) = launched
            cfg = args[6]
            slots = cfg.texture_count
            spec = any(cfg.reproject_specular[:slots])
            ray = cfg.input_type != "diffuse"
            rough = cfg.input_type == "diffuse_specular" or kw.get("roughness_tex") is not None
            nbytes = reproject_bytes(slots, spec, ray, rough) * h * w
            ops = h * w * (2 * RP_OPS_PIXEL + RP_OPS_SLOT * slots)
            ms = (timer(lambda: launch(stage0, planes0, *rest0))
                  + timer(lambda: launch(stage1, planes1, *rest1)))
            route_ms = timer(lambda: reproject_kernel.reproject(*args, **kw))
            plain_ms = timer(lambda: plain(*args, **kw))
            if (h, w) == (HEIGHT, WIDTH):
                results.add(name, "reproject.cu",
                            "none (ops/temporal_reproject.py temporal_reproject_plain's "
                            "elementwise work)", err, 0.0, ms, plain_ms, nbytes, ops)
                results[-1]["route_ms"] = route_ms
            else:
                bound_ms, bound_by = _bound(nbytes, ops)
                print(f"[kernel] {name} at {w}x{h}: max_abs_err={err} (tol 0.0) ms={ms} "
                      f"plain_ms={plain_ms} bound_ms={bound_ms} ({bound_by})", flush=True)
                if not err <= 0.0:
                    raise AssertionError(f"{name} at {w}x{h}: kernel vs plain max abs "
                                         f"error {err} > 0.0")
            print(f"[kernel] {name} at {w}x{h}: {slots} slot(s), the route (prepare, "
                  f"fetches, blend) {route_ms} ms", flush=True)


def shade_bytes(sweep, rays, box):
    """The shade kernel's least bytes a pixel (``csrc/shade.cu``): the
    setup's planes (depth, roughness, metalness, albedo, roughness
    squared, nov, the view normal, v, the two flags, the ems pdf: 62),
    the direct light (12), per ray its direction, hit uv and miss flag
    (21) and the sweep's radiance (16), the specular hit (12), the world
    position with ``box`` (12), the outputs (32); the march's velocity
    and last frame's output (20), each texel read at least once."""
    return 62 + 12 + rays * (21 + (16 if sweep else 0)) + 12 + 12 * box + 32 + (
        0 if sweep else 20)


def check_shade_kernels(torch, analytic, timer, results):
    """SSGI's shade kernel on the inputs of frame 3 of the flagship
    (sweep) at 1920x1080 and 3840x2160 (a ``[kernel]`` line) and of the
    flagship with upstream's per-pixel stack (march) at 1920x1080:
    against ``_shade_plain`` on the same inputs (exact), with the plain
    route's ms."""
    from realism_effects_tpu_torch.ops import shade_kernel
    from realism_effects_tpu_torch.ops import ssgi as ssgi_ops

    real = ssgi_ops._shade
    for name, make, (h, w) in (
            ("shade", analytic.flagship_composer, (HEIGHT, WIDTH)),
            ("shade_march", analytic.flagship_march_composer, (HEIGHT, WIDTH)),
            ("shade", analytic.flagship_composer, (2160, 3840))):
        comp, cam = make(h, w, "cuda")
        seen = []

        def record(*args):
            seen.append(args)
            return real(*args)

        ssgi_ops._shade = record
        try:
            analytic.render_frames(comp, cam, range(4))
        finally:
            ssgi_ops._shade = real
        del comp
        args = seen[-1]
        cfg = args[8]
        got = shade_kernel.shade(*args)
        want = ssgi_ops._shade_plain(*args)
        err = max(_maxerr(torch, g, w_) for g, w_ in zip(got, want, strict=True))
        sweep, rays = cfg.trace == "sweep", 2 if cfg.mode == "ssgi" else 1
        nbytes = shade_bytes(sweep, rays, cfg.env_box is not None) * h * w + int(
            args[5].atlas.data.numel()) * 2
        ops = h * w * (SH_OPS_PIXEL + SH_OPS_RAY * rays)
        ms = timer(lambda: shade_kernel.shade(*args))
        plain_ms = timer(lambda: ssgi_ops._shade_plain(*args))
        if (h, w) == (HEIGHT, WIDTH):
            results.add(name, "shade.cu", f"none (ops/ssgi.py _shade_plain, {cfg.trace})",
                        err, 0.0, ms, plain_ms, nbytes, ops)
            results[-1]["census"] = "shade"
        else:
            bound_ms, bound_by = _bound(nbytes, ops)
            print(f"[kernel] {name} at {w}x{h}: max_abs_err={err} (tol 0.0) ms={ms} "
                  f"plain_ms={plain_ms} bound_ms={bound_ms} ({bound_by})", flush=True)
            if not err <= 0.0:
                raise AssertionError(f"{name} at {w}x{h}: kernel vs plain max abs "
                                     f"error {err} > 0.0")


#: the launch census's keys (``ops/cuda_build.py``), in the order printed
COUNTER_KEYS = (
    "warp_catrom5", "warp_nearest", "warp_bilinear", "minmax", "hbao", "poisson",
    "poisson_2tex", "poisson_1tex", "sweep", "sweep_1ray", "zscan", "zscan_peels",
    "lookup", "warp_multi", "poisson_taps", "sharpness",
    "hbao_noise",   # HBAO's noise table: built once per distance and power
    "ray_march", "motion_blur", "motion_blur_taps",
    "reproject_prepare", "reproject_2slot", "reproject_1slot", "shade")


def counters():
    """The launches since the last :func:`reset_counters`, by census key
    (0 for a key not launched)."""
    from realism_effects_tpu_torch.ops.cuda_build import launches
    return {**dict.fromkeys(COUNTER_KEYS, 0), **launches}


def reset_counters():
    from realism_effects_tpu_torch.ops.cuda_build import launches
    launches.clear()


def check_env_extras(torch):
    """The cube-map and blur routines (plain PyTorch, no kernel of their
    own) at a 128 x 256 map on the card against the CPU: the error
    relative to the map's largest value (tol 1e-3: the card's and the
    CPU's atan2, acos and exp differ by ulps, which moves a bilinear
    tap's fraction) and the card's ms (CUDA events, one call after a
    warm-up call)."""
    from realism_effects_tpu_torch.core import envmap

    sky = torch.as_tensor(envmap.procedural_sky(128, 256))
    faces = envmap.equirect_to_cube(sky, 64)
    runs = {
        "cube_to_equirect": lambda m: envmap.cube_to_equirect(faces.to(m.device), 128, 256),
        "ggx_prefilter_mips": lambda m: envmap.ggx_prefilter_mips(m),
        "blur_env(..., 0.5)": lambda m: envmap.blur_env(m, 0.5),
    }
    for name, fn in runs.items():
        gpu_sky = sky.cuda()
        fn(gpu_sky)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        got = fn(gpu_sky)
        b.record()
        b.synchronize()
        want = fn(sky)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        scale = max(float(w_.abs().max()) for w_ in want)
        err = max(float((g.cpu() - w_).abs().max()) for g, w_ in zip(got, want)) / scale
        print(f"[env] {name} at 128x256: card vs CPU max abs error / map max {err} "
              f"(tol 1e-3), card ms {a.elapsed_time(b)}", flush=True)
        if not err <= 1e-3:
            raise AssertionError(f"{name}: card and CPU disagree, {err} > 1e-3")


def exports_driver(analytic, comp, cam, still, mixer=None):
    """``drive(first, count)`` of a composer through render() (the SSR +
    GTAO + TAA one, the glTF alpha + MSAA one with its ``mixer``): the
    camera still for the frames before ``still``, then one orbit step
    (``analytic.still_then_step``)."""
    return lambda first, n: analytic.render_frames(
        comp, cam, analytic.still_then_step(first, n, still), mixer)


def run_path(torch, comp, drive, name, n, kernels, smi, forbidden=()):
    """``n`` frames after WARMUP warm-up frames, ``drive(first, count)``
    rendering frames first .. first + count - 1 of ``comp``, the counters
    set to 0 just before and read just after; checks the images, that
    each of ``kernels`` launched and that none of ``forbidden`` did; then
    stage times from ``collect_timings``. Returns the launch counts."""
    drive(0, WARMUP)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    images = drive(WARMUP, n)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3 / n
    launches = counters()
    print(f"[path] {name}: launches over {n} frames: {launches}", flush=True)
    for k in kernels:
        if launches[k] <= 0:
            raise AssertionError(f"{k} never launched on the {name} path")
    for k in (*forbidden, "hbao_noise"):
        if launches[k] != 0:
            raise AssertionError(f"{k} launched on the {name} path")
    for img in images:
        if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{name}: non-finite or misshapen frame")
    if not float(images[-1].std()) > 0.01:
        raise AssertionError(f"{name}: flat output image")

    comp.collect_timings = True
    stages = {}
    for f in range(2, 8):
        drive(f, 1)
        for k_, v_ in comp.last_timings.items():
            stages.setdefault(k_, []).append(v_)
    comp.collect_timings = False
    stage_ms = {k_: float(np.median(v_)) for k_, v_ in stages.items()}
    print(f"[path] {WIDTH}x{HEIGHT} {name}: {frame_ms:.4f} ms/frame (host "
          f"clock over {n} frames, synchronised); stages (CUDA events, "
          f"median of 6): {json.dumps(stage_ms)}; card: {smi}", flush=True)
    return launches


def card_vs_cpu(torch, analytic, make, sphere, steps=range(3), capture=None):
    """3 frames at 270x480 on the card and on the CPU through the same
    composer, the camera at orbit indices ``steps`` (``sphere`` None:
    ``make``'s scene through render()); returns per frame
    (max, mean, share of pixels > 1e-2, pixels > 1e-3). ``capture``:
    (effect name, list): the CPU composer's input to that effect, each
    frame, is appended to the list."""
    from realism_effects_tpu_torch.core.camera import PerspectiveCamera

    gpu_comp, gpu_cam, *gpu_mixer = make(270, 480, "cuda")
    cpu_comp, cpu_cam, *cpu_mixer = make(270, 480, "cpu")
    if capture is not None:
        effect = next(e for e in cpu_comp.effects if e.name == capture[0])
        apply = effect.apply
        effect.apply = lambda ctx, color, state: (
            capture[1].append(color.clone()) or apply(ctx, color, state))
    if sphere is None:
        gpu_imgs = analytic.render_frames(gpu_comp, gpu_cam, steps, *gpu_mixer)
        cpu_imgs = analytic.render_frames(cpu_comp, cpu_cam, steps, *cpu_mixer)
    else:
        small_cam = PerspectiveCamera(50, 480 / 270, 0.1, 100)
        small = analytic.frames_at(small_cam, steps, 270, 480, "cuda", sphere=sphere)
        gpu_imgs = analytic.run_frames(gpu_comp, gpu_cam, small, steps)
        cpu_frames = [(gb_.replace(**{f: getattr(gb_, f).cpu() for f in
                                      ("diffuse", "normal", "roughness", "metalness",
                                       "emissive", "depth")}),
                       type(vel_)(velocity=vel_.velocity.cpu(), normal=vel_.normal.cpu(),
                                  depth=vel_.depth.cpu()),
                       col_.cpu()) for gb_, vel_, col_ in small]
        cpu_imgs = analytic.run_frames(cpu_comp, cpu_cam, cpu_frames, steps)
    out = []
    for a, b in zip(gpu_imgs, cpu_imgs):
        d = (a.cpu() - b).abs()
        out.append((float(d.max()), float(d.mean()),
                    float((d.amax(-1) > SSGI_SLICE_PIX_TOL).float().mean()),
                    int((d.amax(-1) > 1e-3).sum())))
    return out


def aa_alone(torch, smaa_in, fxaa_in):
    """SMAA and FXAA alone on the card over the CPU paths' own pre-AA
    frames (270x480, 3 frames each), against the same pass on the CPU:
    SMAA within SMAA_ALONE_MAX_TOL everywhere, FXAA within
    FXAA_ALONE_MAX_TOL but at most FXAA_ALONE_FLIPS pixels a frame (a
    search that ends one texel earlier or later)."""
    from realism_effects_tpu_torch.effects.fxaa import fxaa
    from realism_effects_tpu_torch.effects.smaa import smaa

    for name, fn, inputs, tol, flips in (
            ("SMAA", smaa, smaa_in, SMAA_ALONE_MAX_TOL, 0),
            ("FXAA", fxaa, fxaa_in, FXAA_ALONE_MAX_TOL, FXAA_ALONE_FLIPS)):
        if not inputs:
            raise AssertionError(f"{name}: no pre-AA frame captured")
        for i, img in enumerate(inputs):
            d = (fn(img.cuda()).cpu() - fn(img)).abs().amax(-1)
            n_off = int((d > tol).sum())
            print(f"[path] {name} alone on the CPU path's pre-AA frame {i} "
                  f"(270x480): card vs CPU max {float(d.max())} mean "
                  f"{float(d.mean())}, pixels > {tol}: {n_off}", flush=True)
            if n_off > flips:
                raise AssertionError(f"{name} alone: {n_off} pixels off by more "
                                     f"than {tol} in frame {i}")


def _mesh(torch, n):
    """A row mesh of ``n`` shards: every card when the host has ``n``,
    else ``cuda:0`` repeated."""
    from realism_effects_tpu_torch.parallel.sharding import make_mesh

    if torch.cuda.device_count() == n:
        return make_mesh()
    return make_mesh(["cuda:0"] * n)


def _state_leaves(torch, state):
    """The tensor leaves of a composer state, row blocks joined."""
    from realism_effects_tpu_torch.ops.copy import tree_map
    from realism_effects_tpu_torch.parallel.sharding import gather_rows, is_blocks

    out = []
    tree_map(lambda x: out.append(gather_rows(x) if is_blocks(x) else x),
             state, is_leaf=is_blocks)
    return [x for x in out if isinstance(x, torch.Tensor)]


def check_split(torch, analytic, smi):
    """The split frame at 1920 x 1080 on ``_mesh(torch, SPLIT_SHARDS)``:
    3 frames of HBAO + TRAA on the flagship scene, 3 of the flagship and
    3 of the flagship with the march and the taps through
    ``render(mesh=...)`` (``_build_frame_fn(mesh)``) against the
    same frames without a mesh, every image and every final state leaf
    within SPLIT_TOL; the host ms per frame of both runs (first frames,
    each run ending in a synchronise)."""
    from realism_effects_tpu_torch import EffectComposer, HBAOEffect, TRAAEffect
    from realism_effects_tpu_torch.core.camera import PerspectiveCamera
    from realism_effects_tpu_torch.parallel.sharding import gather_rows

    mesh = _mesh(torch, SPLIT_SHARDS)
    print(f"[split] {SPLIT_SHARDS} shards on {[str(d) for d in mesh]}", flush=True)

    def hbao_traa(h, w, device):
        cam = PerspectiveCamera(50, w / h, 0.1, 100)
        comp = EffectComposer(analytic.flagship_scene(device), cam, w, h,
                              device=device)
        comp.add_effect(HBAOEffect())
        comp.add_effect(TRAAEffect())
        return comp, cam

    def run(make, mesh_):
        comp, cam = make(HEIGHT, WIDTH, "cuda")
        images = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in range(3):
            analytic.orbit(cam, f)
            images.append(comp.render(dt=1 / 60, mesh=mesh_))
        torch.cuda.synchronize()
        return comp, images, (time.perf_counter() - t0) * 1e3 / 3

    for label, make in (("HBAO+TRAA", hbao_traa),
                        ("flagship", analytic.flagship_composer),
                        ("flagship march + taps", analytic.flagship_march_composer)):
        tol = SPLIT_TOL[label]
        ref, want, ref_ms = run(make, None)
        reset_counters()
        comp, got, ms = run(make, mesh)
        launches = {k: v for k, v in counters().items() if v}
        diffs = [float((gather_rows(g) - w).abs().max()) for g, w in zip(got, want)]
        a, b = _state_leaves(torch, ref._state), _state_leaves(torch, comp._state)
        if len(a) != len(b):
            raise AssertionError(f"[split] {label}: {len(b)} state leaves, not {len(a)}")
        state_d = max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))
        print(f"[split] {label}, 3 frames at {WIDTH}x{HEIGHT} split over "
              f"{SPLIT_SHARDS} shards: max abs difference from the unsplit "
              f"frames {diffs}, final state ({len(a)} leaves) {state_d} (tol "
              f"{tol}); placement {json.dumps(comp.last_placement)}; launches "
              f"in the split run {json.dumps(launches)}; host ms/frame split "
              f"{ms:.3f}, unsplit {ref_ms:.3f} (first frames); card: {smi}",
              flush=True)
        if not (max(diffs) <= tol and state_d <= tol):
            raise AssertionError(f"[split] {label} differs from the unsplit frame "
                                 f"by {max(diffs + [state_d])}")
        # per shard: HBAO and the reprojection's warps each shard a frame;
        # whole: the raster's z-scan and the sweep once a frame
        want_n = {"hbao": 3 * SPLIT_SHARDS, "warp_catrom5": 3 * SPLIT_SHARDS,
                  "zscan": 3}
        if label == "flagship":
            want_n.update(sweep=3, poisson_2tex=3 * 2 * SPLIT_SHARDS,
                          shade=3 * SPLIT_SHARDS)
        if label == "flagship march + taps":   # both per shard, a march a ray
            want_n.update(ray_march=3 * 2 * SPLIT_SHARDS,
                          motion_blur_taps=3 * SPLIT_SHARDS, shade=3 * SPLIT_SHARDS)
        short = {k: launches.get(k, 0) for k, n in want_n.items()
                 if launches.get(k, 0) < n}
        if short or (label == "flagship" and launches.get("sweep") != 3):
            raise AssertionError(f"[split] {label}: launches {short or launches} "
                                 f"against {want_n}")
        del ref, comp, want, got


#: the scenes of the demo the [demo] phase drives: (scene, effects, aa,
#: trace)
DEMO_RUNS = (
    ("lights", "ssgi,hbao", "traa", "march"),
    ("dynamic", "ssgi,motion_blur", "taa", "march"),
    ("showcase", "ssr,gtao,sparkle,lens_distortion,gradual_background,tonemap,"
                 "vignette,bloom,sharpness", "smaa", "march"),
    ("traa_test", "hbao", "fxaa", "march"),
    ("gltf", "ssgi", "msaa", "march"),
    ("ao", "hbao", "traa", "sweep"),
)


def check_demo(torch, smi):
    """The port's demo (``tools/demo.py``) on the six scenes it builds in
    code: ``main()`` with each stack for DEMO_FRAMES frames at
    ``--size DEMO_SIZE`` on the card (its steady ms/frame and the kernels
    it launched), then 3 frames at 64 x 64 through ``make_composer`` with
    a fixed frame time, card against CPU, within its AA pass's
    DEMO_BOUNDS."""
    import argparse

    from realism_effects_tpu_torch.tools import demo

    out_dir = os.path.join(ROOT, "build", "demo_smoke")
    bad = []
    for scene, effects, aa, trace in DEMO_RUNS:
        argv = ["--scene", scene, "--effects", effects, "--aa", aa, "--trace", trace,
                "--frames", str(DEMO_FRAMES), "--size", str(DEMO_SIZE),
                "--out", os.path.join(out_dir, scene)]
        reset_counters()
        res = demo.main(argv)
        launches = {k: v for k, v in counters().items() if v}
        if not np.isfinite(res["image"].cpu().numpy()).all():
            raise AssertionError(f"demo {scene}: non-finite frame")
        print(f"[demo] {scene} {effects}+{aa} (trace {trace}) at {DEMO_SIZE}x"
              f"{DEMO_SIZE}: steady {res['steady_ms']:.3f} ms/frame over "
              f"{DEMO_FRAMES} frames (host clock, median of frames 3-"
              f"{DEMO_FRAMES}); launches {json.dumps(launches)}; card: {smi}",
              flush=True)
        tols = DEMO_BOUNDS[aa]
        imgs = {}
        for dev in ("cuda", "cpu"):
            ns = argparse.Namespace(scene=scene, effects=effects, aa=aa, trace=trace,
                                    size=64, device=dev, env=None)
            comp, animate, _ = demo.make_composer(ns)
            imgs[dev] = []
            for f in range(3):
                if animate:
                    animate(f)
                imgs[dev].append(comp.render(dt=1 / 60))
        for i, (a, b) in enumerate(zip(imgs["cuda"], imgs["cpu"])):
            d = (a.cpu() - b).abs()
            mx, mean = float(d.max()), float(d.mean())
            frac = float((d.amax(-1) > SSGI_SLICE_PIX_TOL).float().mean())
            print(f"[demo] {scene} 64x64 frame {i}: card vs CPU max {mx} mean {mean} "
                  f"share of pixels > {SSGI_SLICE_PIX_TOL}: {frac}; pixels > 1e-3: "
                  f"{int((d.amax(-1) > 1e-3).sum())} (tol {tols})", flush=True)
            if not (mx <= tols[0] and mean <= tols[1] and frac <= tols[2]):
                bad.append(f"{scene} frame {i}")
    if bad:
        raise AssertionError(f"demo: card and CPU disagree at {bad}")


#: the bench's modes and the metric each must print last
BENCH_HEADLINE = "frame_ms_1080p_full_stack_ssgi_hbao_traa_mb"
BENCH_RUNS = (((), BENCH_HEADLINE), (("--breakdown",), BENCH_HEADLINE),
              (("--trace", "march"), BENCH_HEADLINE),
              *((("--config", str(n)), f"baseline_config_{n}_{h}p")
                for n, h in ((1, 512), (2, 1080), (3, 1080), (4, 1080), (5, 2160))))
BENCH_STAGES = ("raster_shade", "ssgi", "hbao", "motion_blur", "traa")
BENCH_TIMEOUT = 300   # seconds a mode


def check_bench(smi):
    """The port's bench (``python -m realism_effects_tpu_torch.bench``) in
    a subprocess a mode (BENCH_RUNS; ``--breakdown`` also with ``--json``):
    it must exit 0, and its last stdout line must be the headline record
    of the mode's metric with a finite positive value no larger than its
    median; the breakdown must print a record a stage with its bytes and
    write its artifact with the card's name and power limit."""
    out_dir = os.path.join(ROOT, "build", "bench_smoke")
    os.makedirs(out_dir, exist_ok=True)
    for args, metric in BENCH_RUNS:
        argv = list(args)
        art = os.path.join(out_dir, "breakdown.json")
        if "--breakdown" in args:
            argv += ["--json", art]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "realism_effects_tpu_torch.bench", *argv],
            cwd=ROOT, capture_output=True, text=True, timeout=BENCH_TIMEOUT)
        mode = " ".join(argv) or "default"
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            raise AssertionError(f"bench {mode}: exit {proc.returncode}\n"
                                 f"{proc.stderr[-4000:]}")
        records = [json.loads(line) for line in lines]
        for rec in records:
            print(f"[bench] {mode}: {json.dumps(rec)}", flush=True)
        head = records[-1]
        if set(head) != {"metric", "value", "unit", "median_ms"} or head["metric"] != metric:
            raise AssertionError(f"bench {mode}: last line {head}, expected {metric}")
        if not (np.isfinite(head["value"]) and 0 < head["value"] <= head["median_ms"]):
            raise AssertionError(f"bench {mode}: value {head['value']} "
                                 f"median {head['median_ms']}")
        if "--breakdown" in args:
            passes = [r for r in records if r["metric"].startswith("pass_ms_1080p.")]
            if [r["metric"].split(".", 1)[1] for r in passes] != list(BENCH_STAGES):
                raise AssertionError(f"bench {mode}: stages {passes}")
            if not all(r["gbytes"] > 0 and r["value"] > 0 for r in passes):
                raise AssertionError(f"bench {mode}: a stage without time or bytes")
            with open(art) as f:
                meta = json.load(f)["meta"]
            if meta.get("card") != smi:
                raise AssertionError(f"bench {mode}: meta {meta}, card {smi}")
        print(f"[bench] {mode}: {time.perf_counter() - t0:.1f} s in all; card: {smi}",
              flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on a GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    from realism_effects_tpu_torch import analytic, native
    from realism_effects_tpu_torch.bench import card_line
    from realism_effects_tpu_torch.core.camera import PerspectiveCamera
    from realism_effects_tpu_torch.ops import cuda_build

    # phase 1: card, precision, build
    smi = card_line()
    name = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    t0 = time.perf_counter()
    cuda_build.build_all()
    print(f"[build] {len(cuda_build.SOURCES)} kernels in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for src, log in cuda_build.build_log.items():
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                if "registers" in ln]
        print(f"[build] {src}.cu: {'; '.join(sorted(set(regs)))}", flush=True)
    t0 = time.perf_counter()
    route = ("the C++ library (native/envcdf.cpp)" if native.available()
             else "numpy (the C++ library did not build)")
    print(f"[build] environment CDF tables by {route}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # phase 2: kernels vs plain at the 1080p shapes
    cam = PerspectiveCamera(50, WIDTH / HEIGHT, 0.1, 100)
    frames = analytic.frames_at(cam, range(WARMUP + HBAO_TRAA_FRAMES), HEIGHT, WIDTH,
                                "cuda")
    sph_frames = analytic.frames_at(cam, range(WARMUP + FRAMES), HEIGHT, WIDTH, "cuda",
                                    sphere=True)
    torch.cuda.synchronize()
    timer = Timer(torch)
    kernels = Entries()
    check_kernels(torch, analytic, timer, frames, kernels)
    check_ssgi_kernels(torch, analytic, timer, sph_frames, kernels)
    check_raster_kernels(torch, analytic, timer, kernels)
    check_alpha_kernels(torch, analytic, timer, kernels)
    check_unfused_kernels(torch, analytic, timer, frames, kernels)
    check_ssr_kernels(torch, analytic, timer, kernels)
    check_motion_blur_kernel(torch, analytic, timer, kernels)
    check_march_taps_kernels(torch, analytic, timer, kernels)
    check_reproject_kernels(torch, analytic, timer, kernels)
    check_shade_kernels(torch, analytic, timer, kernels)
    check_env_extras(torch)

    # phase 3: the paths at 1920 x 1080
    def external(comp, cam, frames_):
        return lambda first, n: analytic.run_frames(
            comp, cam, frames_[first:first + n], range(first, first + n))

    def unfused(drive):
        def run(first, n):
            with analytic.unfused():
                return drive(first, n)
        return run

    names = [k["name"] for k in kernels]
    new_kernels = ("warp_multi", "poisson_taps", "sharpness", "sweep_1ray",
                   "poisson_1tex", "zscan_peels", "ray_march", "motion_blur_taps",
                   "shade_march")
    by_path = {}
    comp, cam = analytic.hbao_traa_composer(HEIGHT, WIDTH, "cuda")
    by_path["hbao_traa"] = run_path(
        torch, comp, external(comp, cam, frames), "HBAO+TRAA", HBAO_TRAA_FRAMES,
        ("warp_catrom5", "warp_nearest", "minmax", "hbao", "poisson", "reproject_prepare",
         "reproject_1slot"), smi, forbidden=("ray_march", "reproject_2slot", "shade"))
    del comp
    comp, cam = analytic.ssgi_hbao_traa_composer(HEIGHT, WIDTH, "cuda")
    by_path["ssgi_hbao_traa"] = run_path(
        torch, comp, external(comp, cam, sph_frames), "SSGI+HBAO+TRAA", FRAMES,
        [k for k in names if k not in ("zscan", "lookup", "motion_blur") + new_kernels],
        smi,
        forbidden=("ray_march",))
    del comp, sph_frames
    comp, cam = analytic.flagship_composer(HEIGHT, WIDTH, "cuda")
    by_path["flagship"] = run_path(
        torch, comp, lambda first, n: analytic.render_frames(
            comp, cam, range(first, first + n)),
        "flagship", FRAMES, [k for k in names if k not in new_kernels], smi,
        forbidden=("ray_march",))
    del comp
    comp, cam = analytic.flagship_march_composer(HEIGHT, WIDTH, "cuda")
    by_path["flagship_march"] = run_path(
        torch, comp, lambda first, n: analytic.render_frames(
            comp, cam, range(first, first + n)),
        "flagship with the march and the taps", HBAO_TRAA_FRAMES,
        ("ray_march", "motion_blur_taps", "zscan", "lookup", "hbao", "poisson",
         "poisson_2tex", "warp_catrom5", "warp_nearest", "minmax", "reproject_2slot",
         "reproject_1slot", "shade"), smi,
        forbidden=("sweep", "sweep_1ray", "warp_bilinear", "motion_blur"))
    del comp
    comp, cam = analytic.demo_stack_composer(HEIGHT, WIDTH, "cuda")
    by_path["demo_stack"] = run_path(
        torch, comp, lambda first, n: analytic.render_frames(
            comp, cam, range(first, first + n)),
        "demo stack", HBAO_TRAA_FRAMES,
        ("sharpness", "sweep", "zscan", "lookup", "warp_catrom5", "warp_nearest",
         "warp_bilinear", "minmax", "poisson_2tex", "reproject_2slot", "reproject_1slot",
         "shade"), smi, forbidden=("ray_march",))
    del comp
    comp, cam = analytic.hbao_traa_composer(HEIGHT, WIDTH, "cuda")
    by_path["hbao_traa_unfused"] = run_path(
        torch, comp, unfused(external(comp, cam, frames)), "HBAO+TRAA unfused",
        HBAO_TRAA_FRAMES, ("warp_multi", "poisson_taps", "warp_catrom5",
                           "warp_nearest", "minmax", "reproject_1slot"), smi,
        forbidden=("hbao", "poisson", "ray_march", "shade"))
    del comp, frames
    comp, cam = analytic.reference_exports_composer(HEIGHT, WIDTH, "cuda")
    by_path["ssr_gtao_taa"] = run_path(
        torch, comp, exports_driver(analytic, comp, cam, WARMUP + HBAO_TRAA_FRAMES // 2),
        "SSR+GTAO+TAA", HBAO_TRAA_FRAMES,
        ("sweep_1ray", "warp_catrom5", "warp_nearest", "warp_bilinear", "minmax",
         "poisson", "poisson_1tex", "zscan", "lookup", "reproject_1slot", "shade"), smi,
        forbidden=("hbao", "sweep", "poisson_2tex", "ray_march"))
    del comp
    comp, cam = analytic.march_aa_composer(HEIGHT, WIDTH, "cuda")
    by_path["march_aa"] = run_path(
        torch, comp, lambda first, n: analytic.render_frames(
            comp, cam, range(first, first + n)),
        "SSGI march+SMAA under a cube map", HBAO_TRAA_FRAMES,
        ("ray_march", "zscan", "lookup", "warp_catrom5", "minmax",
         "poisson_2tex", "reproject_2slot", "shade"), smi,
        forbidden=("sweep", "sweep_1ray", "warp_bilinear"))
    del comp
    comp, cam = analytic.ortho_ssr_composer(HEIGHT, WIDTH, "cuda")
    by_path["ortho_ssr"] = run_path(
        torch, comp, lambda first, n: analytic.render_frames(
            comp, cam, range(first, first + n)),
        "ortho SSR march+HBAO+FXAA", HBAO_TRAA_FRAMES,
        ("ray_march", "hbao", "poisson", "poisson_1tex", "minmax",
         "warp_catrom5", "zscan", "lookup", "reproject_1slot", "shade"), smi,
        forbidden=("sweep", "sweep_1ray", "poisson_2tex", "warp_bilinear"))
    del comp
    comp, cam, mixer = analytic.gltf_alpha_msaa_composer(HEIGHT, WIDTH, "cuda")
    by_path["gltf_alpha_msaa"] = run_path(
        torch, comp, exports_driver(analytic, comp, cam, WARMUP + HBAO_TRAA_FRAMES // 2,
                                    mixer),
        "glTF alpha + MSAA 2x", HBAO_TRAA_FRAMES,
        ("zscan_peels", "lookup", "hbao", "poisson", "minmax", "warp_catrom5",
         "warp_nearest", "reproject_1slot"), smi,
        forbidden=("zscan", "sweep", "sweep_1ray", "ray_march", "shade"))
    frames_by_path = {"ssgi_hbao_traa": FRAMES, "flagship": FRAMES}
    for path, counts in by_path.items():
        n = frames_by_path.get(path, HBAO_TRAA_FRAMES)
        ssgi_passes = 0 if counts["shade"] == 0 else n
        print(f"[path] {path}: shade launches {counts['shade']} over {n} frames", flush=True)
        if counts["shade"] != ssgi_passes:
            raise AssertionError(f"{path}: {counts['shade']} shade launches over {n} frames")
    per_frame = by_path["gltf_alpha_msaa"]["zscan_peels"] / HBAO_TRAA_FRAMES
    print(f"[path] glTF alpha + MSAA 2x: zscan_peels launches a frame {per_frame}",
          flush=True)
    if per_frame != 2:   # one a raster: the G-buffer's and the velocity's
        raise AssertionError(f"zscan_peels launched {per_frame} times a frame, not 2")
    del comp
    # each kernel's launches on its own path: the flagship's, the demo
    # stack's for sharpness, the unfused route's for its two kernels
    home = {"sharpness": "demo_stack", "warp_multi": "hbao_traa_unfused",
            "poisson_taps": "hbao_traa_unfused", "sweep_1ray": "ssr_gtao_taa",
            "poisson_1tex": "ssr_gtao_taa", "zscan_peels": "gltf_alpha_msaa",
            "ray_march": "flagship_march", "motion_blur_taps": "flagship_march",
            "shade_march": "flagship_march"}
    for kern in kernels:
        path = home.get(kern["name"], "flagship")
        key = kern.get("census", kern["name"])
        kern["launches"] = by_path[path][key]
        kern["launches_path"] = path
        kern["launches_by_path"] = {p: c[key] for p, c in by_path.items()}
        if kern["launches"] <= 0:
            raise AssertionError(f"{kern['name']} launched on no path")

    # the paths at 270 x 480 on the card against the CPU composer
    def check(name, results, max_tol, mean_tol, frac_tol):
        bad = []
        for i, (mx, mean, frac, n_off) in enumerate(results):
            print(f"[path] {name} 270x480 frame {i}: card vs CPU max {mx} "
                  f"mean {mean} share of pixels > {SSGI_SLICE_PIX_TOL}: {frac}; "
                  f"pixels > 1e-3: {n_off}", flush=True)
            if not (mx <= max_tol and mean <= mean_tol and frac <= frac_tol):
                bad.append(i)
        if bad:
            raise AssertionError(f"{name}: card and CPU disagree at frames {bad}")

    check("HBAO+TRAA", card_vs_cpu(torch, analytic, analytic.hbao_traa_composer, False),
          SLICE_TOL, SLICE_MEAN_TOL, 1.0)
    check("SSGI+HBAO+TRAA", card_vs_cpu(torch, analytic,
                                        analytic.ssgi_hbao_traa_composer, True),
          SSGI_SLICE_MAX_TOL, SSGI_SLICE_MEAN_TOL, SSGI_SLICE_PIX_FRAC)
    check("flagship", card_vs_cpu(torch, analytic, analytic.flagship_composer, None),
          SSGI_SLICE_MAX_TOL, SSGI_SLICE_MEAN_TOL, SSGI_SLICE_PIX_FRAC)
    check("demo stack", card_vs_cpu(torch, analytic, analytic.demo_stack_composer, None),
          SSGI_SLICE_MAX_TOL, SSGI_SLICE_MEAN_TOL, SSGI_SLICE_PIX_FRAC)
    with analytic.unfused():
        check("HBAO+TRAA unfused",
              card_vs_cpu(torch, analytic, analytic.hbao_traa_composer, False),
              UNFUSED_SLICE_MAX_TOL, SLICE_MEAN_TOL, 1.0)
    check("SSR+GTAO+TAA", card_vs_cpu(torch, analytic, analytic.reference_exports_composer,
                                      None, steps=analytic.still_then_step(0, 3, 2)),
          SSGI_SLICE_MAX_TOL, SSGI_SLICE_MEAN_TOL, SSGI_SLICE_PIX_FRAC)
    smaa_in, fxaa_in = [], []
    check("SSGI march+SMAA under a cube map",
          card_vs_cpu(torch, analytic, analytic.march_aa_composer, None,
                      capture=("smaa", smaa_in)),
          AA_SLICE_MAX_TOL, SSGI_SLICE_MEAN_TOL, SSGI_SLICE_PIX_FRAC)
    check("ortho SSR march+HBAO+FXAA",
          card_vs_cpu(torch, analytic, analytic.ortho_ssr_composer, None,
                      capture=("fxaa", fxaa_in)),
          ORTHO_FXAA_MAX_TOL, ORTHO_FXAA_MEAN_TOL, ORTHO_FXAA_PIX_FRAC)
    aa_alone(torch, smaa_in, fxaa_in)
    check("glTF alpha + MSAA 2x",
          card_vs_cpu(torch, analytic, analytic.gltf_alpha_msaa_composer, None,
                      steps=analytic.still_then_step(0, 3, 2)),
          SSGI_SLICE_MAX_TOL, SSGI_SLICE_MEAN_TOL, SSGI_SLICE_PIX_FRAC)

    # phase 4: the split frame, the demo's scenes
    check_split(torch, analytic, smi)
    check_demo(torch, smi)

    # phase 5: the bench, each mode in its own process
    torch.cuda.empty_cache()
    check_bench(smi)

    print(f"[time] {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
