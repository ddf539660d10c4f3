"""What the traced run reads from ``torch.profiler``: the device's
operations, the composer's ``stage:<name>`` ranges, idle gaps.

The arithmetic is copied from the port's ``profile_slice.py``
(``_device_events``, ``_stage_busy``): device busy time is the sum of
the device operations' durations (one stream, so they do not overlap),
and an operation belongs to the stage whose device-side range it starts
in.
"""

from __future__ import annotations

import bisect
import dataclasses

import torch

STAGE = "stage:"


@dataclasses.dataclass
class DeviceTrace:
    """The device side of ``frames`` profiled frames."""

    frames: int
    window_s: float                 # host clock over the profiled frames
    ops: list                       # (name, start us, duration us), by start
    stages: list                    # device-side (start us, end us, stage)
    host_stages: list               # host-side (start us, end us, stage)

    @property
    def busy_s(self) -> float:
        return sum(d for _, _, d in self.ops) / 1e6


def read(prof, frames: int, window_s: float) -> DeviceTrace:
    """The :class:`DeviceTrace` of a finished ``torch.profiler.profile``."""
    cuda = torch.autograd.DeviceType.CUDA
    ops, stages, host_stages = [], [], []
    for e in prof.events():
        rng = (e.time_range.start, e.time_range.end)
        if e.name.startswith(STAGE):
            book = stages if e.device_type == cuda else host_stages
            book.append((*rng, e.name[len(STAGE):]))
        elif e.device_type == cuda:
            ops.append((e.name, rng[0], rng[1] - rng[0]))
    ops.sort(key=lambda o: o[1])
    return DeviceTrace(frames, window_s, ops, sorted(stages), sorted(host_stages))


def _enclosing(ranges: list, t: float):
    """The last range of ``ranges`` (sorted by start) that starts at or
    before ``t`` and ends after it, or None."""
    i = bisect.bisect_right([r[0] for r in ranges], t) - 1
    while i >= 0:
        if ranges[i][1] > t:
            return ranges[i]
        i -= 1
    return None


def stage_busy_ms(trace: DeviceTrace) -> dict:
    """ms a frame of the device operations that start inside each stage's
    device-side range (``profile_slice._stage_busy``)."""
    starts = [s[0] for s in trace.stages]
    busy: dict[str, float] = {}
    for _, start, dur in trace.ops:
        i = bisect.bisect_right(starts, start) - 1
        if i >= 0 and start < trace.stages[i][1]:
            name = trace.stages[i][2]
            busy[name] = busy.get(name, 0.0) + dur / 1e3 / trace.frames
    return busy


def top_ops(trace: DeviceTrace, n: int = 10) -> list:
    """[[name, seconds]] of the ``n`` device operations (by name) that took
    most time over the profiled frames."""
    by_name: dict[str, float] = {}
    for name, _, dur in trace.ops:
        by_name[name] = by_name.get(name, 0.0) + dur / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:160], s] for name, s in top]


def idle_gaps(trace: DeviceTrace, n: int = 10) -> list:
    """[[what the host was in, seconds]] of the ``n`` longest gaps between
    consecutive device operations, each labelled with the host-side
    ``stage:`` range that held the gap's start (``between stages`` when
    none did)."""
    gaps = []
    end = None
    for _, start, dur in trace.ops:
        if end is not None and start > end:
            gaps.append((start - end, end))
        end = max(end or 0.0, start + dur)
    gaps.sort(key=lambda g: -g[0])
    out = []
    for length, at in gaps[:n]:
        r = _enclosing(trace.host_stages, at)
        out.append([f"{STAGE}{r[2]}" if r else "between stages", length / 1e6])
    return out
