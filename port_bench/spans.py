"""The program's own spans and counters (``realism_effects_tpu_torch.tracing``)
for the per-layer metrics that read them.

The harness's phases run with the program's tracing off, so the
metrics they give read as they always have. The profiler gives a
``record_function`` range a device-side range only over the device work
launched directly inside it, not inside a range nested in it: with the
``pass:`` spans on, a ``stage:`` range would lose its passes' work, so
the profiled phase cannot also carry the spans. The readers here share
one traced pass instead, run at the first reader's call and kept on the
reader's context (``ctx.program_trace``): a new composer of the cell
from the run's ``--seed``, its warm-up frames, then with tracing on

- the traffic file's ``profiled_frames`` frames under ``torch.profiler``
  (after one frame for the profiler's own start-up): the device
  operations, the device-side ``pass:`` ranges and the host-side spans
  on the profiler's clock;
- its ``synced_frames`` frames, each started on an empty queue, with no
  profiler: the program's records of each frame (``tracing.frames()``).

Nothing is read (every reader returns None) where the harness's profile
holds no device operation, or where the program has no ``tracing``
module. The pass also prints on stderr the waits a frame by site, the
call places of unnamed waits, the passes' sums against the harness's
stage metrics, and ``idle_gaps_by_span``: the longest idle gaps of its
profiled frames, each labelled with the innermost program span open on
the host at the gap's start (``between spans`` where none is).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import sys
import time
from collections import Counter

import torch

from port_bench import trace

PROGRAM = "realism_effects_tpu_torch"
#: the names of the program's spans: ``frame`` and these prefixes
PREFIXES = ("stage:", "pass:", "wait:")
PASS = "pass:"


def is_span(name: str) -> bool:
    return name == "frame" or name.startswith(PREFIXES)


@dataclasses.dataclass
class ProgramTrace:
    """What the traced pass saw.

    ``synced``: one list of span records a synced frame (objects with
    ``name``, ``ms`` and ``counters``, as ``tracing.Span``).
    ``profiled``: a :class:`trace.DeviceTrace` of the profiled frames
    whose ``stages`` are the device-side ``pass:`` ranges (named
    ``<stage>.<pass>``) and whose ``host_stages`` are the host-side
    program spans under their full names."""

    synced: list
    profiled: trace.DeviceTrace


def get(ctx) -> ProgramTrace | None:
    """The run's :class:`ProgramTrace`, made at the first call."""
    if not hasattr(ctx, "program_trace"):
        ctx.program_trace = None
        t = time.perf_counter()
        ctx.program_trace = _run(ctx)
        if ctx.program_trace is not None:
            _report(ctx, ctx.program_trace, time.perf_counter() - t)
    return ctx.program_trace


def _seed() -> int:
    """The run's ``--seed``, from the command line: the reader's context
    does not carry it."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--seed", type=int)
    seed = ap.parse_known_args(sys.argv[1:])[0].seed
    if seed is None:
        raise RuntimeError("port_bench.spans: the traced pass needs the run's --seed "
                           "on the command line")
    return seed


def _run(ctx) -> ProgramTrace | None:
    if not ctx.trace.ops or not torch.cuda.is_available():
        return None
    if importlib.util.find_spec(f"{PROGRAM}.tracing") is None:
        print(f"[spans] not read: {PROGRAM} has no tracing module", file=sys.stderr)
        return None
    import realism_effects_tpu_torch as program
    from realism_effects_tpu_torch import tracing

    from port_bench.inputs import Inputs
    from port_bench.rig import Rig

    cell = ctx.cell
    device = torch.device("cuda", torch.cuda.current_device())
    inputs = Inputs(cell, _seed())
    rig = Rig(program, cell, inputs, device)
    f = 0
    for _ in range(inputs.warmup):
        rig.render(f)
        f += 1
    torch.cuda.synchronize(device)
    spec = cell.traffic["trace"]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    tracing.enable()
    try:
        with torch.profiler.profile(activities=acts):   # the profiler's own start-up
            rig.render(f)
            f += 1
            torch.cuda.synchronize(device)
        n = spec["profiled_frames"]
        with torch.profiler.profile(activities=acts) as prof:
            t = time.perf_counter()
            for _ in range(n):
                rig.render(f)
                f += 1
            torch.cuda.synchronize(device)
            window_s = time.perf_counter() - t
        tracing.clear()
        for _ in range(spec["synced_frames"]):
            torch.cuda.synchronize(device)
            rig.render(f)
            f += 1
        torch.cuda.synchronize(device)
        synced = [g for g in tracing.frames() if g and g[0].name == "frame"]
    finally:
        tracing.disable()
        tracing.clear()
    profiled = read_profile(prof, n, window_s)
    del rig, prof
    gc.collect()
    torch.cuda.empty_cache()
    return ProgramTrace(synced, profiled)


def read_profile(prof, frames: int, window_s: float) -> trace.DeviceTrace:
    """The profiled frames' device operations, device-side ``pass:``
    ranges and host-side program spans (see :class:`ProgramTrace`)."""
    cuda = torch.autograd.DeviceType.CUDA
    ops, passes, host = [], [], []
    for e in prof.events():
        rng = (e.time_range.start, e.time_range.end)
        if is_span(e.name):
            if e.device_type != cuda:
                host.append((*rng, e.name))
            elif e.name.startswith(PASS):
                passes.append((*rng, e.name[len(PASS):]))
        elif e.device_type == cuda:
            ops.append((e.name, rng[0], rng[1] - rng[0]))
    ops.sort(key=lambda o: o[1])
    return trace.DeviceTrace(frames, window_s, ops, sorted(passes), sorted(host))


def stage_extents(dt: trace.DeviceTrace) -> trace.DeviceTrace:
    """``dt`` with each run of consecutive ``pass:`` ranges of one stage
    merged into one range named after the stage: from its first pass's
    start to its last pass's end, on the device."""
    merged = []
    for lo, hi, name in dt.stages:
        stage = name.split(".", 1)[0]
        if merged and merged[-1][2] == stage:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi), stage)
        else:
            merged.append((lo, hi, stage))
    return dataclasses.replace(dt, stages=merged)


def _gaps(dt: trace.DeviceTrace) -> list:
    """(length us, start us) of every gap between consecutive device
    operations (``trace.idle_gaps``' arithmetic)."""
    gaps, end = [], None
    for _, start, dur in dt.ops:
        if end is not None and start > end:
            gaps.append((start - end, end))
        end = max(end or 0.0, start + dur)
    return gaps


def idle_gaps_by_span(dt: trace.DeviceTrace, n: int = 10) -> list:
    """[[innermost program span open on the host at the gap's start, s]]
    of the ``n`` longest idle gaps."""
    out = []
    for length, at in sorted(_gaps(dt), key=lambda g: -g[0])[:n]:
        r = trace._enclosing(dt.host_stages, at)
        out.append([r[2] if r else "between spans", length / 1e6])
    return out


# --- the readers' arithmetic ------------------------------------------------

def _frames(ctx):
    pt = get(ctx)
    return pt.synced if pt is not None and pt.synced else None


def waits_per_frame(ctx):
    """Host synchronisations with the card a synced frame, named and
    unnamed."""
    frames = _frames(ctx)
    if frames is None:
        return None
    return sum(s.counters.get("syncs", 0) for g in frames for s in g) / len(frames)


def wait_ms(ctx):
    """Host ms a synced frame inside ``wait:`` spans."""
    frames = _frames(ctx)
    if frames is None:
        return None
    return sum(s.ms for g in frames for s in g if s.name.startswith("wait:")) / len(frames)


def work_ms(ctx):
    """Host ms a frame inside ``render()`` outside the waits: phase 2's
    host ms a synced frame (``host_enqueue_ms``: tracing off, before any
    profiler) less :func:`wait_ms`. The traced pass's own ``frame``
    spans are not used: they run after the profiled phases, where the
    host runs a flagship frame slower by more than the tracing costs."""
    wait = wait_ms(ctx)
    if wait is None or not ctx.enqueue_ms:
        return None
    return sum(ctx.enqueue_ms) / len(ctx.enqueue_ms) - wait


def idle_after_wait_ms(ctx):
    """Device idle ms a profiled frame in the gaps that start while the
    host is inside a ``wait:`` span."""
    pt = get(ctx)
    if pt is None or not pt.profiled.ops:
        return None
    waits = [r for r in pt.profiled.host_stages if r[2].startswith("wait:")]
    idle = sum(length for length, at in _gaps(pt.profiled)
               if trace._enclosing(waits, at) is not None)
    return idle / 1e3 / pt.profiled.frames


def pass_busy_ms(ctx, name: str):
    """Device ms a profiled frame of the operations that start inside the
    device-side range of ``pass:<name>`` (``trace.stage_busy_ms``'s
    arithmetic over the pass ranges)."""
    pt = get(ctx)
    if pt is None:
        return None
    return trace.stage_busy_ms(pt.profiled).get(name)


def _report(ctx, pt: ProgramTrace, seconds: float):
    """What the traced pass saw, on stderr."""
    frames, prof = pt.synced, pt.profiled
    sites, unnamed = Counter(), Counter()
    for g in frames:
        for s in g:
            if s.counters.get("syncs"):
                sites[s.name] += s.counters["syncs"] / len(frames)
            if s.name == "wait:unnamed":
                unnamed[s.counters.get("at", "?")] += 1 / len(frames)
    say = lambda *a: print("[spans]", *a, file=sys.stderr)
    say(f"traced pass {seconds:.1f} s; waits a frame by site "
        f"{json.dumps(dict(sites.most_common()))}")
    if unnamed:
        say(f"unnamed waits a frame by call place {json.dumps(dict(unnamed.most_common()))}")
    if frames and ctx.enqueue_ms:
        say(f"host ms a synced frame: traced {sum(g[0].ms for g in frames) / len(frames)!r} "
            f"(wait {wait_ms(ctx)!r}), untraced {sum(ctx.enqueue_ms) / len(ctx.enqueue_ms)!r}")
    say(f"profiled ms a frame: traced {prof.window_s * 1e3 / prof.frames!r}, untraced "
        f"{ctx.trace.window_s * 1e3 / ctx.trace.frames!r}; launches a frame: traced "
        f"{len(prof.ops) / prof.frames!r}, untraced {len(ctx.trace.ops) / ctx.trace.frames!r}")
    untraced = Counter(name for name, _, _ in ctx.trace.ops)
    traced = Counter(name for name, _, _ in prof.ops)
    moved = {name[:80]: [untraced[name] / ctx.trace.frames, traced[name] / prof.frames]
             for name in untraced | traced
             if untraced[name] * prof.frames != traced[name] * ctx.trace.frames}
    if moved:
        say(f"operations a frame, untraced and traced, where they differ {json.dumps(moved)}")
    stages = trace.stage_busy_ms(ctx.trace)
    extents = trace.stage_busy_ms(stage_extents(prof))
    passes = trace.stage_busy_ms(prof)
    for st in sorted(stages):
        mine = {k: v for k, v in passes.items() if k.startswith(st + ".")}
        say(f"stage {st}: passes {sum(mine.values())!r} ms, the same frames from its first "
            f"pass to its last {extents.get(st)!r}, the harness's stage {stages[st]!r}: "
            f"{json.dumps(mine)}")
    say(f"idle_gaps_by_span {json.dumps(idle_gaps_by_span(prof))}")
