"""Where the time of a frame of the port's paths goes on the card.

    python -m realism_effects_tpu_torch.profile_slice [--frames 24]
        [--width 1920] [--height 1080]
        [--path all|hbao_traa|ssgi_hbao_traa|flagship|demo_stack|hbao_traa_unfused|ssr_gtao_taa|march_aa|ortho_ssr|gltf_alpha_msaa]

Renders the analytic scene (``analytic.py``) through
``EffectComposer.render_external`` with ``HBAOEffect()`` +
``TRAAEffect()`` (path ``hbao_traa``; path ``hbao_traa_unfused`` the
same with HBAO and the Poisson denoiser on the unfused route of
``analytic.unfused()``) or ``SSGIEffect()`` + ``HBAOEffect()`` +
``TRAAEffect()`` under the flagship's environment, with the flagship's
sphere in the scene (path ``ssgi_hbao_traa``); or the flagship scene
through ``EffectComposer.render``: raster, shade, then SSGI, HBAO,
motion blur and TRAA (path ``flagship``) or the reference demo's stack,
SSGI, tone mapping, TRAA, sharpness, vignette, bloom and a grading LUT
(path ``demo_stack``), or the reference's other three exports, SSR,
GTAO and TAA, with the camera still and then one orbit step half way
through the host-timed frames (path ``ssr_gtao_taa``), or SSGI with the
per-pixel march and SMAA under a cube-map environment (path
``march_aa``), or SSR with the march, HBAO and FXAA under an
orthographic camera (path ``ortho_ssr``), or a GLB written and loaded
back, with a box of material alpha and a cutout quad, the box animated,
rendered with ``msaa=2`` and three alpha peels under HBAO and TRAA, the
camera still and then one step as on ``ssr_gtao_taa`` (path
``gltf_alpha_msaa``). After 4 warm-up
frames, ``--frames`` frames timed on the host clock (synchronised at the
end), 4 frames with ``collect_timings``, then ``--frames`` frames under
``torch.profiler``. Prints one JSON line a path: host ms/frame, each
stage's CUDA-event time, device busy ms/frame (the sum of the CUDA
kernels' durations; one stream, so they do not overlap), the device's
idle share of the frame, kernel launches a frame, the time in the port's
kernels, the device busy time of each composer stage (the kernels that
start inside its ``stage:<name>`` profiler range), and the costliest
kernels. Fails without a CUDA device; reports device time as not
measured when the profiler records no CUDA kernels.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import sys
import time

import torch

from . import analytic
from .bench import card_line
from .core.camera import PerspectiveCamera
from .ops import cuda_build

PORT_KERNELS = ("warp_kernel", "warp_multi_kernel", "minmax_kernel",
                "sharpness_kernel", "hbao_kernel", "hbao_noise_kernel",
                "poisson_kernel",
                "taps_kernel", "sweep_kernel", "zscan_kernel", "zscan_prep_kernel",
                "zscan_peels_kernel", "lookup_kernel")
PATHS = ("hbao_traa", "ssgi_hbao_traa", "flagship", "demo_stack",
         "hbao_traa_unfused", "ssr_gtao_taa", "march_aa", "ortho_ssr",
         "gltf_alpha_msaa")
WARM = 4


def _driver(path: str, h: int, w: int, n: int):
    """``drive(first, count)``: render frames first .. first + count - 1
    of ``path``'s composer on the card; and the composer."""
    if path in ("flagship", "demo_stack", "march_aa", "ortho_ssr"):
        make = {"flagship": analytic.flagship_composer,
                "demo_stack": analytic.demo_stack_composer,
                "march_aa": analytic.march_aa_composer,
                "ortho_ssr": analytic.ortho_ssr_composer}[path]
        comp, cam = make(h, w, "cuda")
        return (lambda first, count: analytic.render_frames(
            comp, cam, range(first, first + count))), comp
    if path in ("ssr_gtao_taa", "gltf_alpha_msaa"):
        make = (analytic.reference_exports_composer if path == "ssr_gtao_taa"
                else analytic.gltf_alpha_msaa_composer)
        comp, cam, *mixer = make(h, w, "cuda")
        still = WARM + (n - WARM) // 4
        return (lambda first, count: analytic.render_frames(
            comp, cam, analytic.still_then_step(first, count, still), *mixer)), comp
    make, sphere = {"hbao_traa": (analytic.hbao_traa_composer, False),
                    "hbao_traa_unfused": (analytic.hbao_traa_composer, False),
                    "ssgi_hbao_traa": (analytic.ssgi_hbao_traa_composer, True)}[path]
    cam = PerspectiveCamera(50, w / h, 0.1, 100)
    frames = analytic.frames_at(cam, range(n), h, w, "cuda", sphere=sphere)
    comp, cam = make(h, w, "cuda")

    def drive(first, count):
        with (analytic.unfused() if path == "hbao_traa_unfused"
              else contextlib.nullcontext()):
            return analytic.run_frames(comp, cam, frames[first:first + count],
                                       range(first, first + count))
    return drive, comp


def _device_events(prof):
    """(kernels, stage ranges): the profiler's device-side events, split
    into the kernels and the ``stage:<name>`` ranges of the composer
    (which the profiler also places on the device timeline)."""
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == cuda]
    stages = sorted((e.time_range.start, e.time_range.end, e.name[len("stage:"):])
                    for e in events if e.name.startswith("stage:"))
    return [e for e in events if not e.name.startswith("stage:")], stages


def _stage_busy(kernels, stages, n: int) -> dict:
    """ms a frame of the kernels that start inside each stage's range."""
    starts = [s[0] for s in stages]
    busy: dict[str, float] = {}
    for e in kernels:
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start < stages[i][1]:
            name = stages[i][2]
            busy[name] = busy.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / n
    return busy


def profile_path(path: str, h: int, w: int, n: int, smi: str) -> dict:
    warm = WARM
    drive, comp = _driver(path, h, w, warm + 2 * n)
    drive(0, warm)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    drive(warm, n)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n

    comp.collect_timings = True
    stages: dict[str, list] = {}
    for f in range(warm + n, warm + n + 4):
        drive(f, 1)
        for k, v in comp.last_timings.items():
            stages.setdefault(k, []).append(v)
    comp.collect_timings = False

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        drive(warm + n, n)
        torch.cuda.synchronize()
        prof_host_ms = (time.perf_counter() - t0) * 1e3 / n
    events, stage_ranges = _device_events(prof)
    out = {"path": path, "card": smi, "width": w, "height": h, "frames": n,
           "host_ms_per_frame": host_ms,
           "host_ms_per_frame_profiled": prof_host_ms,
           # CUDA events around each stage (median of 4 frames); they also
           # count the device's waits for the host
           "stage_ms": {k: sorted(v)[len(v) // 2] for k, v in stages.items()}}
    if not events:
        out["device_busy_ms_per_frame"] = "not measured"
        return out
    by_name: dict[str, list] = {}
    for e in events:
        rec = by_name.setdefault(e.name, [0, 0.0])
        rec[0] += 1
        rec[1] += e.time_range.elapsed_us() / 1e3
    busy = sum(v[1] for v in by_name.values()) / n
    port = {k: sum(v[1] for name, v in by_name.items() if k in name) / n
            for k in PORT_KERNELS}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    out.update({
        "device_busy_ms_per_frame": busy,
        "stage_device_busy_ms_per_frame": _stage_busy(events, stage_ranges, n),
        # against the unprofiled frame: the profiler slows the host only
        "device_idle_share": max(0.0, 1.0 - busy / host_ms),
        "launches_per_frame": len(events) / n,
        "port_kernels_ms_per_frame": port,
        "other_kernels_ms_per_frame": busy - sum(port.values()),
        "top_kernels": [{"name": k[:90], "per_frame": v[0] / n,
                         "ms_per_frame": v[1] / n} for k, v in top],
    })
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--path", choices=["all", *PATHS], default="all")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_slice: no CUDA device", file=sys.stderr)
        return 1
    smi = card_line()
    cuda_build.build_all()
    rc = 0
    for path in (PATHS if args.path == "all" else [args.path]):
        out = profile_path(path, args.height, args.width, args.frames, smi)
        print(json.dumps(out), flush=True)
        if out["device_busy_ms_per_frame"] == "not measured":
            rc = 2
    return rc


if __name__ == "__main__":
    sys.exit(main())
