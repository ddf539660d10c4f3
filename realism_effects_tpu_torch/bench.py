"""Benchmark: frame time of the flagship post-processing stack on the card.

    python -m realism_effects_tpu_torch.bench [--breakdown] [--config n]
        [--scene sponza] [--trace march|sweep] [--json PATH] [--device cpu]

The port's counterpart of the JAX package's ``bench.py`` (at the
repository's root; ``bench.py:n`` below is a line of it): the same
scenes, effect stacks, motions, modes and metric names. Prints one JSON
line a record on stdout; the last line is always the headline record,
``{"metric", "value", "unit": "ms/frame", "median_ms"}``:

- by default ``frame_ms_1080p_full_stack_ssgi_hbao_traa_mb``: the
  flagship frame through ``EffectComposer.render`` (a 20 x 20 plane, a
  unit box and a metallic sphere under the procedural sky; SSGI + HBAO +
  motion blur + TRAA) at 1920 x 1080, the camera orbiting 0.01 rad a
  frame (:func:`_orbit`);
- ``--config n`` (1..5) ``baseline_config_<n>_<h>p``, one of the staged
  configurations (:func:`build_config`; a 24 x 24 plane):

  1. TRAA at 512 x 512 on the scene written to a GLB and loaded back;
  2. HBAO with 4 denoise iterations at 1920 x 1080, static;
  3. motion blur + TRAA at 1920 x 1080, the camera orbiting 0.02 rad a
     frame;
  4. SSGI (20 steps, 5 refine steps) at 1920 x 1080, static;
  5. the full stack at 3840 x 2160, the box translating and rotating and
     the camera orbiting 0.01 rad a frame;

- ``--scene sponza``: ``frame_ms_sponza_1080p_full_stack_ssgi_hbao_traa_mb``,
  the flagship stack on the reference project's Sponza
  (``example/public/gltf/sponza_no_textures.optimized.glb`` under the
  directory ``REALISM_EFFECTS_REFERENCE`` names, as ``tools/demo.py``
  finds it; it is not in this repository, and without it the bench
  exits non-zero naming the path), the camera panning 0.01 rad a frame;
- ``--breakdown`` adds, before the headline, the per-frame-synced frame
  time ``frame_ms_1080p_per_frame_synced`` with ``sync_floor_ms``, and one
  ``pass_ms_1080p.<stage>`` record a composer stage (``raster_shade``, the
  raster and shade of the scene, then the effects by name); with
  ``--scene sponza`` ``pass_ms_sponza_1080p.<stage>``.

``--trace march|sweep`` (default sweep) picks the discretisation of the
SSGI trace and of motion blur: the direction-binned sweep with
``MotionBlurEffect(mode="sweep")``, or the reference's per-pixel march
with ``mode="taps"``. The ``<h>p`` of a name is the frame's height.

Timing. The host enqueues a frame's kernels and returns before the card
has run them, so a frame is timed between barriers: a barrier is
``torch.cuda.synchronize`` followed by the read of one scalar of the
image (``float(img.max())``, which also fails the run on a non-finite
frame). The CUDA kernels are built by ``nvcc`` before the first frame
and the environment with the scene, so neither falls in a timed batch;
``WARMUP`` frames then run, each closed by a barrier. Then ``BATCHES``
batches of ``ITERS`` frames run back to back with one barrier at the end
of each, timed on the host clock. Frames follow one another on the card,
each reading the temporal state the one before wrote. ``value`` is the
best batch's ms per frame and ``median_ms`` the median batch's: the card
does the same work every frame, so the spread between batches is the
host's (the frame is bound by the host's launch rate). ``sync_floor_ms``
is the time of one barrier on a tensor that is already computed: what a
per-frame barrier adds to each frame of the per-frame-synced record.

The stage times of ``--breakdown`` are CUDA events around each composer
stage (``EffectComposer.collect_timings``), the best of ``ITERS``
frames. Events time the card's stream, not the host's round trip, so no
sync floor is subtracted from them. They include the card's waits for
the host inside a stage, and they sum to more than the pipelined frame.

``--json PATH`` writes the records and ``meta`` (trace, statistic, the
1-minute load average, the device, and on the card its name and power
limit as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
prints them). There each ``pass_ms`` record also gets ``gbytes``, the
bytes the stage must move, counted over one frame by :class:`Traffic`
(each tensor that existed before the stage and that it reads, once, and
each tensor it creates and returns or writes in place, once: the least
traffic of the stage, whatever implements it), and, on the card,
``hbm_util`` = gbytes / stage time / 3.35 TB/s (the H100 SXM's HBM3 rate,
NVIDIA's data sheet). There is no FLOP count and no MFU: the stages do no
tensor-core work, and eager PyTorch counts no elementwise operations.

The bench runs on the card unless ``--device cpu`` is given, and raises
when CUDA is absent and the CPU was not asked for. ``--device cpu`` runs
the kernels' plain PyTorch versions, for tests only: each record then
carries ``"device": "cpu"``, and its times are not the card's.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from . import analytic
from .composer import EffectComposer, resolve_device
from .core.camera import PerspectiveCamera
from .core.envmap import build_equirect_env, procedural_sky
from .effects.ao import HBAOEffect
from .effects.motion_blur import MotionBlurEffect
from .effects.ssgi import SSGIEffect
from .effects.traa import TRAAEffect
from .ops import cuda_build
from .ops.copy import tree_map
from .scene.geometry import rotation_y, translation
from .scene.gltf import load_gltf, load_gltf_asset, write_glb
from .scene.scene import Scene
from .tools import demo

WIDTH, HEIGHT = 1920, 1080
WARMUP = 2       # frames before the timed batches, each closed by a barrier
ITERS = 12       # frames a batch
BATCHES = 4      # batches, one barrier each; value = the best batch
SYNCED = 8       # per-frame-synced frames of --breakdown
#: (height, width) of the staged configurations (``bench.py:281-282``)
CONFIG_SIZES = {1: (512, 512), 2: (1080, 1920), 3: (1080, 1920),
                4: (1080, 1920), 5: (2160, 3840)}
MEM_BW = 3.35e12  # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
SPONZA_GLB = ("example", "public", "gltf", "sponza_no_textures.optimized.glb")
#: the port's stage names as the JAX bench reports them: the unsplit
#: frame's ``raster`` stage shades too
STAGE_NAMES = {"raster": "raster_shade"}


# ---------------------------------------------------------------------
# scenes, stacks and motions
# ---------------------------------------------------------------------

def _mb(trace: str) -> MotionBlurEffect:
    """Motion blur in the discretisation of ``trace``."""
    return MotionBlurEffect(mode="sweep" if trace == "sweep" else "taps")


def _flagship_stack(comp: EffectComposer, trace: str) -> EffectComposer:
    """SSGI + HBAO + motion blur + TRAA (``bench.py:203-206``)."""
    for effect in (SSGIEffect(trace=trace), HBAOEffect(), _mb(trace), TRAAEffect()):
        comp.add_effect(effect)
    return comp


def _camera(width: int, height: int) -> PerspectiveCamera:
    cam = PerspectiveCamera(50, width / height, 0.1, 100)
    cam.set_position(3, 2.5, 4)
    cam.look_at((0, 0.5, 0))
    return cam


def _orbit(cam, f: int, rad_per_frame: float = 0.01):
    """Camera of frame ``f``: radius 4 at height 2.5, ``rad_per_frame``
    a frame (``bench.py:359-362``; config 3 takes 0.02)."""
    ang = 0.6 + rad_per_frame * f
    cam.set_position(4 * np.sin(ang), 2.5, 4 * np.cos(ang))
    cam.look_at((0, 0.5, 0))


def build_composer(width: int, height: int, device, trace: str = "sweep"):
    """The flagship frame (``bench.py:180-207``): (composer, camera)."""
    dev = resolve_device(device)
    cam = _camera(width, height)
    comp = EffectComposer(analytic.flagship_scene(dev), cam, width, height, device=dev)
    return _flagship_stack(comp, trace), cam


def build_config(n: int, width: int, height: int, device, trace: str = "sweep"):
    """Staged configuration ``n`` (``bench.py:272-346``; its size is
    ``CONFIG_SIZES[n]``): (composer, animate or None, metric name)."""
    dev = resolve_device(device)
    meshes = analytic.flagship_meshes(plane=24)
    if n == 1:
        # a glTF scene: the procedural fixture through the GLB writer and loader
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "bench_config_1.glb")
            write_glb(meshes, path)
            meshes = load_gltf(path)
    scene = analytic.flagship_scene(dev, meshes)
    box = scene.meshes[1]
    cam = _camera(width, height)
    comp = EffectComposer(scene, cam, width, height, device=dev)
    animate = None
    if n == 1:
        comp.add_effect(TRAAEffect())
    elif n == 2:
        comp.add_effect(HBAOEffect(denoise_iterations=4))
    elif n == 3:
        comp.add_effect(_mb(trace))
        comp.add_effect(TRAAEffect())
        animate = lambda f: _orbit(cam, f, 0.02)
    elif n == 4:
        comp.add_effect(SSGIEffect(steps=20, refine_steps=5, trace=trace))
    else:
        _flagship_stack(comp, trace)

        def animate(f):
            t = f / 60.0
            box.set_matrix(translation(np.sin(t * 2.5) * 1.2, 0.5, 0) @ rotation_y(t * 3))
            _orbit(cam, f)
    return comp, animate, f"baseline_config_{n}_{height}p"


def sponza_path() -> str:
    """The Sponza asset's path under the reference project's checkout."""
    return os.path.join(demo.reference_dir(), *SPONZA_GLB)


def build_sponza_composer(width: int, height: int, device, trace: str = "sweep"):
    """The flagship stack on the reference's Sponza (``bench.py:214-241``):
    (composer, camera). Exits naming the path when the asset is absent."""
    path = sponza_path()
    if not os.path.exists(path):
        raise SystemExit(f"bench --scene sponza needs the reference project's "
                         f"asset {path} (set REALISM_EFFECTS_REFERENCE to a "
                         "checkout of 0beqz/realism-effects)")
    dev = resolve_device(device)
    scene = Scene()
    scene.environment = build_equirect_env(procedural_sky(64, 128), device=dev)
    for mesh in load_gltf_asset(path).meshes:
        scene.add(mesh)
    scene.sun_intensity = 1.4
    cam = PerspectiveCamera(55, width / height, 0.05, 400)
    cam.set_position(8.0, 2.2, -0.5)
    cam.look_at((-6.0, 3.0, 0.0))
    comp = EffectComposer(scene, cam, width, height, device=dev)
    return _flagship_stack(comp, trace), cam


def _sponza_orbit(cam, f: int):
    """A small pan inside the colonnade, 0.01 rad a frame
    (``bench.py:244-249``)."""
    ang = 0.01 * f
    cam.set_position(8.0 - 0.2 * np.sin(ang), 2.2, -0.5 + 0.2 * np.cos(ang))
    cam.look_at((-6.0, 3.0, 0.0))


# ---------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------

class Driver:
    """Renders one composer's frames in order: ``animate(f)`` (None for a
    still scene), then ``render(dt=1/60)``; returns the image."""

    def __init__(self, composer: EffectComposer, animate=None):
        self.composer = composer
        self.animate = animate
        self.frame = 0

    def __call__(self) -> torch.Tensor:
        if self.animate is not None:
            self.animate(self.frame)
        self.frame += 1
        return self.composer.render(dt=1 / 60)


def _sync(img: torch.Tensor) -> float:
    """The barrier: wait for the card, then read one scalar of ``img``;
    raises on a non-finite frame."""
    if img.device.type == "cuda":
        torch.cuda.synchronize(img.device)
    v = float(img.max())
    if not math.isfinite(v):
        raise RuntimeError(f"a non-finite frame (max {v})")
    return v


def sync_floor_ms(device, samples: int = 6) -> float:
    """The time of one barrier on a tensor that is already computed, best
    of ``samples``."""
    x = torch.ones(8, device=device)
    _sync(x)
    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        _sync(x)
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times)


def _measure(drive: Driver) -> tuple[float, float]:
    """(best, median) batch ms per frame (see the module docstring)."""
    for _ in range(WARMUP):
        _sync(drive())
    batch_ms = []
    for _ in range(BATCHES):
        t0 = time.perf_counter()
        for _ in range(ITERS):
            img = drive()
        _sync(img)
        batch_ms.append((time.perf_counter() - t0) * 1e3 / ITERS)
    return min(batch_ms), float(np.median(batch_ms))


def _measure_stages(drive: Driver) -> dict[str, float]:
    """Best-of-``ITERS`` ms of each composer stage (CUDA events on the
    card, no sync floor subtracted), by the JAX bench's stage names."""
    comp = drive.composer
    times: dict[str, list] = {}
    comp.collect_timings = True
    try:
        for _ in range(ITERS):
            _sync(drive())
            for k, v in comp.last_timings.items():
                times.setdefault(STAGE_NAMES.get(k, k), []).append(v)
    finally:
        comp.collect_timings = False
    return {k: min(v) for k, v in times.items()}


# ---------------------------------------------------------------------
# the bytes a stage moves
# ---------------------------------------------------------------------

class Traffic(TorchDispatchMode):
    """The bytes a stage must move, counted while it runs: each tensor on
    ``device`` that existed before the stage and that one of its
    operations or kernels reads, once, and each such tensor that it
    writes in place, once; :meth:`total` adds the tensors the stage
    creates and returns. A tensor counts by the elements it sees (a
    broadcast dimension once), the views of one storage together at most
    the storage. Views read nothing. Kernels are seen through
    ``cuda_build.require_cuda``, which every kernel wrapper calls on its
    inputs."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.device = device
        self.created: set[int] = set()
        self.read: dict[int, list] = {}
        self.written: dict[int, list] = {}

    def _note(self, book: dict, t, made: bool = False) -> None:
        """Count tensor ``t`` in ``book`` (storage -> [its bytes, {view:
        bytes}]) if it is on the device and the stage created it (``made``)
        or not (by default)."""
        if not (isinstance(t, torch.Tensor) and t.device == self.device and t.numel()):
            return
        storage = t.untyped_storage()
        if (storage.data_ptr() in self.created) != made:
            return
        seen = math.prod(s for s, st in zip(t.shape, t.stride()) if st)
        view = (t.storage_offset(), tuple(t.shape), tuple(t.stride()))
        book.setdefault(storage.data_ptr(), [storage.nbytes(), {}])[1][view] = (
            seen * t.element_size())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        written = set()
        for i, a in enumerate(func._schema.arguments):
            v = args[i] if i < len(args) else kwargs.get(a.name)
            book = (self.written if a.alias_info is not None
                    and a.alias_info.is_write else self.read)
            for t in tree_leaves(v):
                self._note(book, t)
                if book is self.written and isinstance(t, torch.Tensor):
                    written.add(t.untyped_storage().data_ptr())
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                key = t.untyped_storage().data_ptr()
                if key not in written:
                    self.created.add(key)
        return out

    def __enter__(self):
        self._require = cuda_build.require_cuda

        def require(*tensors):
            for t in tensors:
                self._note(self.read, t)
            return self._require(*tensors)

        cuda_build.require_cuda = require
        return super().__enter__()

    def __exit__(self, *exc):
        cuda_build.require_cuda = self._require
        return super().__exit__(*exc)

    def total(self, outputs) -> int:
        """Bytes read and written in place, and those of the tensors of
        ``outputs`` (a nested dict/list/tuple/dataclass) that the stage
        created."""
        made: dict[int, list] = {}
        tree_map(lambda t: self._note(made, t, made=True) or t, outputs)
        return sum(min(cap, sum(views.values()))
                   for book in (self.read, self.written, made)
                   for cap, views in book.values())


def stage_bytes(drive: Driver) -> dict[str, int]:
    """The bytes each composer stage moves (:class:`Traffic`) over one
    frame of ``drive``, by the JAX bench's stage names."""
    comp = drive.composer
    out: dict[str, int] = {}

    def wrap(name, fn):
        def run(*args, **kwargs):
            with Traffic(comp.device) as traffic:
                result = fn(*args, **kwargs)
            out[name] = traffic.total(result)
            return result
        return run

    comp._raster = wrap(STAGE_NAMES["raster"], comp._raster)
    for e in comp.effects:
        e.apply = wrap(e.name, e.apply)
    try:
        _sync(drive())
    finally:
        del comp._raster
        for e in comp.effects:
            del e.apply
    return out
def stage_bytes(drive: Driver) -> dict[str, int]:
    """The bytes each composer stage moves (:class:`Traffic`) over one
    frame of ``drive``, by the JAX bench's stage names."""
    comp = drive.composer
    out: dict[str, int] = {}

    def wrap(name, fn):
        def run(*args, **kwargs):
            with Traffic(comp.device) as traffic:
                result = fn(*args, **kwargs)
            out[name] = traffic.total(result)
            return result
        return run

    comp._raster = wrap(STAGE_NAMES["raster"], comp._raster)
    for e in comp.effects:
        e.apply = wrap(e.name, e.apply)
    try:
        _sync(drive())
    finally:
        del comp._raster
        for e in comp.effects:
            del e.apply
    return out


# ---------------------------------------------------------------------
# the runs
# ---------------------------------------------------------------------

def _pass_records(drive: Driver, prefix: str, roofline: bool) -> list[dict]:
    """One ``<prefix>.<stage>`` record a stage; with ``roofline`` its
    ``gbytes`` and, on the card, ``hbm_util``."""
    stages = _measure_stages(drive)
    nbytes = stage_bytes(drive) if roofline else {}
    on_card = drive.composer.device.type == "cuda"
    records = []
    for name, ms in stages.items():
        rec = {"metric": f"{prefix}.{name}", "value": round(ms, 3), "unit": "ms/frame"}
        if name in nbytes:
            rec["gbytes"] = round(nbytes[name] / 1e9, 4)
            rec["hbm_util"] = (round(nbytes[name] / (ms / 1e3) / MEM_BW, 4)
                               if on_card else "not measured")
        records.append(rec)
    return records


def _headline(metric: str, best: float, median: float) -> dict:
    return {"metric": metric, "value": round(best, 3), "unit": "ms/frame",
            "median_ms": round(median, 3)}


def run_default(device, trace: str, breakdown: bool, roofline: bool) -> list[dict]:
    """The flagship frame; with ``breakdown`` the per-frame-synced record
    and the per-pass records before the headline."""
    comp, cam = build_composer(WIDTH, HEIGHT, device, trace)
    drive = Driver(comp, lambda f: _orbit(cam, f))
    best, median = _measure(drive)
    records = []
    if breakdown:
        floor = sync_floor_ms(comp.device)
        synced = []
        for _ in range(SYNCED):
            t0 = time.perf_counter()
            _sync(drive())
            synced.append((time.perf_counter() - t0) * 1e3)
        records.append({"metric": f"frame_ms_{HEIGHT}p_per_frame_synced",
                        "value": round(min(synced), 3), "unit": "ms/frame",
                        "sync_floor_ms": round(floor, 3)})
        records += _pass_records(drive, f"pass_ms_{HEIGHT}p", roofline)
    return records + [_headline(f"frame_ms_{HEIGHT}p_full_stack_ssgi_hbao_traa_mb",
                                best, median)]


def run_sponza(device, trace: str, breakdown: bool, roofline: bool) -> list[dict]:
    """The flagship stack on Sponza; with ``breakdown`` the per-pass
    records before the headline."""
    comp, cam = build_sponza_composer(WIDTH, HEIGHT, device, trace)
    drive = Driver(comp, lambda f: _sponza_orbit(cam, f))
    best, median = _measure(drive)
    records = (_pass_records(drive, f"pass_ms_sponza_{HEIGHT}p", roofline)
               if breakdown else [])
    return records + [_headline(
        f"frame_ms_sponza_{HEIGHT}p_full_stack_ssgi_hbao_traa_mb", best, median)]


def run_config(n: int, device, trace: str) -> list[dict]:
    height, width = CONFIG_SIZES[n]
    comp, animate, name = build_config(n, width, height, device, trace)
    return [_headline(name, *_measure(Driver(comp, animate)))]


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]


def _warn_if_loaded():
    """The frame is bound by the host's launch rate: other load on the
    host's cores inflates these times. Say so on stderr."""
    try:
        load1 = os.getloadavg()[0]
    except OSError:
        return
    ncpu = os.cpu_count() or 1
    if load1 > 0.5 * ncpu:
        print(f"[bench] WARNING: 1-min loadavg {load1:.1f} on {ncpu} CPUs; "
              "other load inflates these host-bound times", file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", type=int, choices=sorted(CONFIG_SIZES),
                    help="a staged configuration instead of the flagship frame")
    ap.add_argument("--scene", choices=["sponza"],
                    help="the flagship stack on the reference's Sponza")
    ap.add_argument("--breakdown", action="store_true",
                    help="per-frame-synced and per-pass records")
    ap.add_argument("--trace", choices=["sweep", "march"], default="sweep")
    ap.add_argument("--json", metavar="PATH", help="write the records and meta")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions (tests only); "
                         "default: the card")
    args = ap.parse_args(argv)
    _warn_if_loaded()
    device = resolve_device(args.device)
    meta = {"trace": args.trace, "statistic": (
        f"value: the best of {BATCHES} batches of {ITERS} frames on the host "
        "clock between barriers, median_ms: the median batch; pass_ms: CUDA "
        f"events, best of {ITERS} frames")}
    try:
        meta["loadavg_1min"] = round(os.getloadavg()[0], 2)
    except OSError:
        pass
    if device.type == "cuda":
        meta["device"] = torch.cuda.get_device_name(device)
        meta["card"] = card_line()
        print(f"[bench] {meta['card']}", file=sys.stderr)
        t0 = time.perf_counter()
        cuda_build.build_all()
        print(f"[bench] kernels built in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr)
    else:
        meta["device"] = str(device)
        print(f"[bench] on {device}: the kernels' plain PyTorch versions; "
              "these times are not the card's", file=sys.stderr)
    if args.config is not None:
        records = run_config(args.config, device, args.trace)
    elif args.scene == "sponza":
        records = run_sponza(device, args.trace, args.breakdown, args.json is not None)
    else:
        records = run_default(device, args.trace, args.breakdown, args.json is not None)
    for rec in records:
        if device.type != "cuda":
            rec["device"] = str(device)
        print(json.dumps(rec), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"meta": meta, "records": records}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
