"""Run one cell of the benchmark on the card.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's scene and effect stack in ``realism_effects_tpu_torch``
from the inputs ``--seed`` draws (``inputs.py``), renders the traffic
file's warm-up frames, then renders frames back to back through
``EffectComposer.render`` for ``--seconds`` on the host clock, and prints
one JSON line last on stdout.

Untraced (``--trace 0``), the end-to-end metrics:

- ``frame_ms``: the window's wall time over the frames rendered in it.
  The window opens after a barrier that ends the warm-up and closes with
  one barrier (``torch.cuda.synchronize``) after its last frame: the
  traffic file's ``compare.frames`` frames are started once
  ``--seconds`` have passed, and the comparison replays them;
- ``frame_ms.device_paced``: the same, in the cells that list it (those
  the card paces), under a bound of their own;
- ``frame_ms_p95``: the 95th percentile of the intervals between the
  device-side completions of consecutive frames (a CUDA event recorded
  after each ``render`` returns, read after the closing barrier);
- ``gpu_ms``: the card's busy time a frame, the sum of the device
  operations' durations over the traffic file's ``profiled_frames``
  frames, rendered under ``torch.profiler`` right after the window (in
  every cell: the device time of a cell the host paces, whose wall time
  a frame follows the host's speed, and beside ``frame_ms`` elsewhere);
  the seconds this phase takes, ``trace.read`` included, go to stderr;
- ``peak_mem_mib``: ``torch.cuda.max_memory_allocated()`` over set-up and
  the window, read before the window's last frames (while they run, the
  comparison holds on to the state before them; every frame allocates
  alike);
- ``setup_s``: from the start of this process to the window's opening:
  imports, the CUDA context, the kernels' build or load from
  ``build/kernels/``, the scene and environment, the warm-up frames.

Traced (``--trace 1``), the same window, then the traffic file's
``synced_frames`` frames each started on an empty queue (host time
inside ``render``), then ``profiled_frames`` frames under
``torch.profiler``; the per-layer metrics are read from those by
``metrics/<name>.py``, and ``device`` gains ``busy_s`` and ``window_s`` of
the profiled frames.

Every run then holds two of the program's frames against the plain
reference, and the reference's stages against their independent
references (``check.py``), and prints each number compared beside its
limit as its last lines on stderr and under ``checks``, the result's
last key. Exits non-zero without a result when CUDA is absent or has
fewer devices than the cell asks for, and when ``jax``, ``jaxlib``,
``flax``, ``realism_effects_tpu`` or ``bench`` is loaded once the window
has closed (top-level module names compared whole).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from port_bench import check, manifest, trace  # noqa: E402
from port_bench.inputs import Inputs  # noqa: E402
from port_bench.rig import Rig  # noqa: E402

#: top-level module names no run may hold: the JAX package and its
#: stack, and the JAX repository's root ``bench.py``
BANNED = ("jax", "jaxlib", "flax", "realism_effects_tpu", "bench")


def banned_modules() -> list:
    """The loaded modules whose top-level name is one of :data:`BANNED`."""
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


class Traced:
    """What a per-layer reader gets: the cell, the pipelined frames' wall
    ms a frame, the synced frames' host ms inside ``render``, and the
    profiled frames' :class:`trace.DeviceTrace`."""

    def __init__(self, cell, wall_ms_per_frame, enqueue_ms, device_trace):
        self.cell = cell
        self.wall_ms_per_frame = wall_ms_per_frame
        self.enqueue_ms = enqueue_ms
        self.trace = device_trace


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(rig, first: int, seconds: float, tail: int, device) -> dict:
    """Frames ``first``, ``first + 1``, ... back to back until ``tail``
    frames have started after ``seconds``; see the module docstring. The
    program's state before those ``tail`` frames is kept for the
    comparison, which replays them."""
    cuda = device.type == "cuda"
    marks = []   # CUDA events: the window's opening, then each frame's end

    def mark():
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()

    _sync(device)
    mark()
    f = first
    left = None
    t0 = time.perf_counter()
    while True:
        if left is None and time.perf_counter() - t0 >= seconds:
            peak = torch.cuda.max_memory_allocated(device) if cuda else 0
            state_in, replay_from, left = rig.state(), f, tail
        image = rig.render(f)
        mark()
        f += 1
        if left is not None:
            left -= 1
            if left == 0:
                break
    _sync(device)
    t1 = time.perf_counter()
    intervals = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    return {"t0": t0, "frames": f - first, "wall_s": t1 - t0, "intervals_ms": intervals,
            "peak_bytes": peak, "first": replay_from, "last": f - 1,
            "state_in": state_in, "image": image, "state_out": rig.state()}


def traced_phases(rig, cell, first: int, device) -> tuple:
    """The synced frames' host ms inside ``render`` and the profiled
    frames' device trace, from frame ``first``."""
    spec = cell.traffic["trace"]
    f = first
    enqueue = []
    for _ in range(spec["synced_frames"]):
        _sync(device)
        t = time.perf_counter()
        rig.render(f)
        enqueue.append((time.perf_counter() - t) * 1e3)
        f += 1
    return enqueue, profiled(rig, cell, f, device)


def profiled(rig, cell, first: int, device) -> trace.DeviceTrace:
    """The traffic file's ``profiled_frames`` frames from frame ``first + 1``
    under ``torch.profiler`` (frame ``first`` takes the profiler's own
    start-up): their :class:`trace.DeviceTrace`."""
    f = first
    _sync(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):   # the profiler's own start-up
        rig.render(f)
        f += 1
        _sync(device)
    n = cell.traffic["trace"]["profiled_frames"]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        for _ in range(n):
            rig.render(f)
            f += 1
        _sync(device)
        window_s = time.perf_counter() - t
    return trace.read(prof, n, window_s)


def compare(cell, inputs, device, start_prog: dict, win: dict) -> dict:
    """{frame: {number: value}} of the two compared frames (``check.py``);
    each tensor's own gaps go to stderr."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    ref, records = check.reference_start(cell, inputs, device)
    start, per_start = check.numbers({k: v.to(device) for k, v in start_prog.items()}, ref)
    del ref
    t_start = time.perf_counter() - t
    t = time.perf_counter()
    stages, per_stages = check.stage_numbers(records)
    del records
    t_stages = time.perf_counter() - t
    prog = check.outputs(win["image"], win["state_out"])
    t = time.perf_counter()
    ref = check.reference_step(cell, inputs, win["state_in"], win["first"], win["last"],
                               device)
    last, per_last = check.numbers(prog, ref)
    print(f"[reference] start {t_start:.3f} s, stages {t_stages:.3f} s, last "
          f"{win['last'] - win['first'] + 1} frames {time.perf_counter() - t:.3f} s",
          file=sys.stderr)
    for frame, per in (("start", per_start), ("stages", per_stages), ("last", per_last)):
        for k, (mx, mean) in per.items():
            print(f"[gap] {frame}.{k} max {mx!r} mean {mean!r}", file=sys.stderr)
    return {"start": start, "stages": stages, "last": last}


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def program_run(cell, seed: int, seconds: float, traced: bool, device) -> tuple:
    """The program's side of a run: (inputs, its last warm-up frame's
    outputs on the host, the window, the traced phases' :class:`Traced`
    or None). The program is freed on return; the window keeps the
    tensors the comparison needs."""
    import realism_effects_tpu_torch as program

    torch.set_num_threads(1)
    inputs = Inputs(cell, seed)
    rig = Rig(program, cell, inputs, device)
    for f in range(inputs.warmup):
        image = rig.render(f)
    _sync(device)
    start_prog = check.to_host(check.outputs(image, rig.state()))
    win = window(rig, inputs.warmup, seconds, int(cell.traffic["compare"]["frames"]),
                 device)
    ctx = None
    if traced:
        enqueue, dev_trace = traced_phases(rig, cell, win["last"] + 1, device)
        ctx = Traced(cell, win["wall_s"] * 1e3 / win["frames"], enqueue, dev_trace)
    elif any(m["name"] == "gpu_ms" for m in cell.end_to_end):
        t = time.perf_counter()
        win["profiled"] = profiled(rig, cell, win["last"] + 1, device)
        print(f"[profiled] {time.perf_counter() - t:.3f} s after the window",
              file=sys.stderr)
    del rig, image
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return inputs, start_prog, win, ctx


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             t_start: float) -> dict:
    """One run of ``cell`` on ``device``: the result line's dict."""
    inputs, start_prog, win, ctx = program_run(cell, seed, seconds, traced, device)
    setup_s = win["t0"] - t_start
    readings = compare(cell, inputs, device, start_prog, win)
    ok, rows = check.judge(readings, cell.traffic["compare"]["limits"])

    metrics = {}
    names = {m["name"]: m for m in (cell.per_layer if traced else cell.end_to_end)}
    if traced:
        for name, m in names.items():
            value = cell.reader(name).read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": m["unit"]}
    else:
        frame_ms = win["wall_s"] * 1e3 / win["frames"]
        e2e = {"frame_ms": frame_ms, "frame_ms.device_paced": frame_ms,
               "peak_mem_mib": win["peak_bytes"] / 2 ** 20, "setup_s": setup_s}
        if win["intervals_ms"]:
            e2e["frame_ms_p95"] = statistics.quantiles(
                win["intervals_ms"], n=20, method="inclusive")[18]
        gpu = win.get("profiled")
        if gpu is not None and gpu.ops:
            e2e["gpu_ms"] = gpu.busy_s * 1e3 / gpu.frames
        metrics = {k: {"value": e2e[k], "unit": m["unit"]} for k, m in names.items()
                   if k in e2e}
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": kind,
           "count": 1, "memory_peak_bytes": win["peak_bytes"]}
    result = {"correct": ok, "attempted": win["frames"],
              "failed": len({k.split(".")[0] for k, v, lim in rows
                             if lim is None or v > lim}),
              "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": trace.top_ops(ctx.trace),
                               "idle_gaps": trace.idle_gaps(ctx.trace)}
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = manifest.resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"port_bench: {args.workload} needs {cell.chips} CUDA device(s), "
              f"found {n}", file=sys.stderr)
        return 2
    print(f"[port_bench] card: {card_line()}", file=sys.stderr, flush=True)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    found = banned_modules()
    if found:
        print(f"port_bench: modules that no run may load: {found}", file=sys.stderr)
        return 3
    for name, row in result["checks"].items():
        print(f"[check] {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
