#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (realism_effects_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Print the card's name and power limit, turn TF32 off, and build the
   CUDA kernels from ``realism_effects_tpu_torch/csrc`` (nvcc, sm_90a).
2. Hold each kernel against its plain PyTorch version on the card at the
   1920x1080 shapes of the HBAO + TRAA path, with the stated tolerance,
   and time both with CUDA events (median of 25 launches, L2 flushed
   before each, the card kept busy while the host prepares a launch). Where one PyTorch call computes the same function, time
   it too (``library_ms``; the port never calls it).
3. Run the path: ``EffectComposer(None, cam, 1920, 1080)`` with
   ``HBAOEffect()`` + ``TRAAEffect()``, ``render_external`` over 24
   frames of analytic buffers (a ground plane and a box, ray-cast per
   pixel on the card with the camera orbiting). The launch counters are
   set to 0 just before those frames and read just after: every kernel
   must have run. Then a 3-frame run at 270x480 must agree with the same
   composer on the CPU.
4. Print the ``kernels`` JSON line, then the device JSON line last.

The script imports nothing of JAX. It needs the repository beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

WIDTH, HEIGHT = 1920, 1080
FRAMES = 24
WARMUP = 4            # frames before the timed ones: allocator and clocks
MEM_BW = 3.35e12      # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
F32_RATE = 67e12      # H100 SXM float32 outside the tensor cores, op/s

# Slice tolerance against the CPU composer (tests/test_torch_slice.py):
# max 1e-3 (a few pixels on a nearest-texel snap or the Poisson weight
# cut-off flip with one ulp), mean 1e-5.
SLICE_TOL = 1e-3
SLICE_MEAN_TOL = 1e-5

# Operations per pixel of the two kernels whose arithmetic rivals their
# bytes, counted from the kernels' source: every add, multiply, compare,
# min/max, division, square root and transcendental is one operation
# (a lower bound: libm's sinf/expf/logf take tens of instructions).
HBAO_OPS_SETUP = 61       # uv, ndc, two transform_points, the basis
HBAO_OPS_SAMPLE = 135     # direction, projection, fetch index, integral
POISSON_OPS_SETUP = 90    # 3 normal decodes, flatness, noise angle
POISSON_OPS_TAP = 45      # offsets, snap, normal decode, edge weights
POISSON_OPS_TAP_SLOT = 45  # per slot: unpack, logs, luma, age blend


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


# ---------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------

def check_kernels(torch, analytic, timer, frames):
    """Each kernel against its plain version at the path's 1080p shapes."""
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
    results = []

    def entry(name, source, replaces, err, tol, ms, plain_ms, nbytes, ops,
              library_ms=None):
        bound_ms, bound_by = _bound(nbytes, ops)
        if not err <= tol:
            raise AssertionError(f"{name}: kernel vs plain max abs error "
                                 f"{err} > {tol}")
        results.append(dict(
            name=name, route="cuda",
            source=f"realism_effects_tpu_torch/csrc/{source}",
            replaces=replaces, launches=None, max_abs_err=err, tol=tol,
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms))
        print(f"[kernel] {name}: max_abs_err={err} (tol {tol}) ms={ms} "
              f"plain_ms={plain_ms} bound_ms={bound_ms} ({bound_by}) "
              f"library_ms={library_ms}", flush=True)

    def maxerr(a, b):
        torch.cuda.synchronize()
        return float((a.float() - b.float()).abs().max())

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
    entry("warp_catrom5", "warp.cu", "realism_effects_tpu/ops/pallas/warp.py:91",
          err, 1e-6,
          timer(lambda: warp._launch(*args, 8, "catrom5", 30)),
          timer(lambda: warp.window_warp_plain(*args, ky=8, mode="catrom5", kx=30)),
          nbytes, h * w * (4 * 32 + 30))

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
    entry("warp_nearest", "warp.cu", "realism_effects_tpu/ops/pallas/warp.py:91",
          err, 1e-6,
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
    entry("minmax", "stencil.cu", "realism_effects_tpu/ops/pallas/stencil.py:180",
          err, 0.0, timer(lambda: stencil._launch(inp, 2)),
          timer(lambda: stencil.neighborhood_minmax_plain(inp, 2)),
          inp.nbytes * 3, h * w * 4 * 25 * 2, library_ms=timer(lib))

    # HBAO, spp 8, 32 x 32 window, on the frame's depth and normals
    cam = PerspectiveCamera(50, w / h, 0.1, 100)
    analytic.orbit(cam, 1)
    mats = cam.matrices()
    cfg = AOConfig()
    k = hbao_kernel.hbao_fused(gb.depth, gb.normal, mats, 1, cfg)
    p = hbao_kernel.hbao_fused_plain(gb.depth, gb.normal, mats, 1, cfg)
    err = maxerr(k, p)
    tile = 128 * 128 * 4 * 4
    entry("hbao", "hbao.cu", "realism_effects_tpu/ops/pallas/hbao.py:58",
          err, 2e-4,
          timer(lambda: hbao_kernel._launch(gb.depth, gb.normal, mats, 1, cfg)),
          timer(lambda: hbao_kernel.hbao_fused_plain(gb.depth, gb.normal, mats, 1, cfg)),
          gb.depth.nbytes + gb.normal.nbytes + tile + k.nbytes,
          h * w * (HBAO_OPS_SETUP + cfg.spp * HBAO_OPS_SAMPLE))

    # Poisson AO pass: one scalar slot, radius 3
    ao_tex = torch.cat([k[..., None].expand(h, w, 3), torch.zeros_like(k)[..., None]], -1)
    pcfg = PoissonDenoiseConfig()
    bundle, ch = poisson_kernel.pack_bundle([ao_tex], gb, (True,))
    kk = poisson_kernel.poisson_pass_fused([ao_tex], gb, 2, pcfg, scalar_slots=(True,))[0]
    p = poisson_kernel.poisson_pass_plain(bundle, ch, (True,), 2, pcfg)
    err = maxerr(kk, p)
    entry("poisson", "poisson.cu", "realism_effects_tpu/ops/pallas/poisson.py:126",
          err, 5e-4,
          timer(lambda: poisson_kernel._launch(bundle, ch, (True,), 2, pcfg)),
          timer(lambda: poisson_kernel.poisson_pass_plain(bundle, ch, (True,), 2, pcfg)),
          bundle.nbytes + tile + p.nbytes,
          h * w * (POISSON_OPS_SETUP + 8 * (POISSON_OPS_TAP + POISSON_OPS_TAP_SLOT)))
    return results


def counters():
    from realism_effects_tpu_torch.ops import (hbao_kernel, poisson_kernel,
                                               stencil, warp)
    return {
        "warp_catrom5": warp.window_warp.mode_launches["catrom5"],
        "warp_nearest": warp.window_warp.mode_launches["nearest"],
        "minmax": stencil.neighborhood_minmax.launches,
        "hbao": hbao_kernel.hbao_fused.launches,
        "poisson": poisson_kernel.poisson_pass_fused.launches,
    }


def reset_counters():
    from realism_effects_tpu_torch.ops import (hbao_kernel, poisson_kernel,
                                               stencil, warp)
    warp.window_warp.launches = 0
    for m in warp.window_warp.mode_launches:
        warp.window_warp.mode_launches[m] = 0
    stencil.neighborhood_minmax.launches = 0
    hbao_kernel.hbao_fused.launches = 0
    poisson_kernel.poisson_pass_fused.launches = 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from realism_effects_tpu_torch import analytic
    from realism_effects_tpu_torch.core.camera import PerspectiveCamera
    from realism_effects_tpu_torch.ops import cuda_build

    # phase 1: card, precision, build
    smi = _smi()
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

    # phase 2: kernels vs plain at the 1080p shapes
    cam = PerspectiveCamera(50, WIDTH / HEIGHT, 0.1, 100)
    frames = analytic.frames_for(cam, WARMUP + FRAMES, HEIGHT, WIDTH, "cuda")
    torch.cuda.synchronize()
    timer = Timer(torch)
    kernels = check_kernels(torch, analytic, timer, frames)

    # phase 3: the path at 1920 x 1080
    comp, cam = analytic.hbao_traa_composer(HEIGHT, WIDTH, "cuda")
    analytic.run_frames(comp, cam, frames[:WARMUP])
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    images = analytic.run_frames(comp, cam, frames[WARMUP:], first=WARMUP)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3 / FRAMES
    launches = counters()
    print(f"[path] launches over {FRAMES} frames: {launches}", flush=True)
    for kern in kernels:
        kern["launches"] = launches[kern["name"]]
        if kern["launches"] <= 0:
            raise AssertionError(f"{kern['name']} never launched on the path")
    for img in images:
        if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError("non-finite or misshapen frame")
    last = images[-1]
    if not float(last.std()) > 0.01:
        raise AssertionError("flat output image")

    comp.collect_timings = True
    stages = {}
    for f in range(2, 8):
        analytic.orbit(cam, f)
        comp.render_external(*frames[f], dt=1 / 60)
        for k_, v_ in comp.last_timings.items():
            stages.setdefault(k_, []).append(v_)
    stage_ms = {k_: float(np.median(v_)) for k_, v_ in stages.items()}
    print(f"[path] {WIDTH}x{HEIGHT} HBAO+TRAA: {frame_ms:.4f} ms/frame "
          f"(host clock over {FRAMES} frames, synchronised); stages "
          f"(CUDA events, median of 6): {json.dumps(stage_ms)}; card: {smi}",
          flush=True)

    # the path at 270 x 480 on the card against the CPU composer
    small_cam = PerspectiveCamera(50, 480 / 270, 0.1, 100)
    small = analytic.frames_for(small_cam, 3, 270, 480, "cuda")
    gpu_comp, gpu_cam = analytic.hbao_traa_composer(270, 480, "cuda")
    cpu_comp, cpu_cam = analytic.hbao_traa_composer(270, 480, "cpu")
    gpu_imgs = analytic.run_frames(gpu_comp, gpu_cam, small)
    cpu_frames = [(gb_.replace(**{f: getattr(gb_, f).cpu() for f in
                                  ("diffuse", "normal", "roughness", "metalness",
                                   "emissive", "depth")}),
                   type(vel_)(velocity=vel_.velocity.cpu(), normal=vel_.normal.cpu(),
                              depth=vel_.depth.cpu()),
                   col_.cpu()) for gb_, vel_, col_ in small]
    cpu_imgs = analytic.run_frames(cpu_comp, cpu_cam, cpu_frames)
    for i, (a, b) in enumerate(zip(gpu_imgs, cpu_imgs)):
        d = (a.cpu() - b).abs()
        print(f"[path] 270x480 frame {i}: card vs CPU max {float(d.max())} "
              f"mean {float(d.mean())}", flush=True)
        if not (float(d.max()) <= SLICE_TOL and float(d.mean()) <= SLICE_MEAN_TOL):
            raise AssertionError(f"card and CPU composers disagree at frame {i}")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
