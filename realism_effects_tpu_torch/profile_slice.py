"""Where the time of a frame of the port's paths goes on the card.

    python -m realism_effects_tpu_torch.profile_slice [--frames 24]
        [--width 1920] [--height 1080] [--path all|hbao_traa|ssgi_hbao_traa]

Renders the analytic scene (``analytic.py``) through
``EffectComposer.render_external`` with ``HBAOEffect()`` +
``TRAAEffect()`` (path ``hbao_traa``) or ``SSGIEffect()`` +
``HBAOEffect()`` + ``TRAAEffect()`` under the flagship's environment,
with the flagship's sphere in the scene (path ``ssgi_hbao_traa``): after
4 warm-up frames, ``--frames`` frames timed on the host clock
(synchronised at the end), then the same number under
``torch.profiler``. Prints one JSON line a path: host ms/frame, device
busy ms/frame (the sum of the CUDA kernels' durations; one stream, so
they do not overlap), the device's idle share of the frame, kernel
launches a frame, the time in the port's kernels, and the costliest
kernels. Fails without a CUDA device; reports device time as not
measured when the profiler records no CUDA kernels.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from . import analytic
from .core.camera import PerspectiveCamera
from .ops import cuda_build

PORT_KERNELS = ("warp_kernel", "minmax_kernel", "hbao_kernel",
                "poisson_kernel", "sweep_kernel")
PATHS = {"hbao_traa": (analytic.hbao_traa_composer, False),
         "ssgi_hbao_traa": (analytic.ssgi_hbao_traa_composer, True)}


def _kernel_events(prof):
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events() if e.device_type == cuda]


def profile_path(path: str, h: int, w: int, n: int, smi: str) -> dict:
    make, sphere = PATHS[path]
    cam = PerspectiveCamera(50, w / h, 0.1, 100)
    warm = 4
    frames = analytic.frames_for(cam, warm + 2 * n, h, w, "cuda", sphere=sphere)
    comp, cam = make(h, w, "cuda")
    analytic.run_frames(comp, cam, frames[:warm])
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    analytic.run_frames(comp, cam, frames[warm:warm + n], first=warm)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        analytic.run_frames(comp, cam, frames[warm + n:], first=warm + n)
        torch.cuda.synchronize()
        prof_host_ms = (time.perf_counter() - t0) * 1e3 / n
    events = _kernel_events(prof)
    out = {"path": path, "card": smi, "width": w, "height": h, "frames": n,
           "host_ms_per_frame": host_ms,
           "host_ms_per_frame_profiled": prof_host_ms}
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
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
