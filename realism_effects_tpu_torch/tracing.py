"""Spans and counters of the frame path, off by default.

What a frame's host time is spent on, and which pass of an effect
launched which device work:

- ``frame``: one span a :meth:`EffectComposer.render` /
  ``render_external``, carrying the composer's frame index, which every
  span opened inside it shares;
- ``stage:<name>``: the composer's stages (:func:`stage`). These open a
  ``torch.profiler.record_function`` range whether tracing is on or
  off, as the composer always has: tools that read a profile take every
  range whose name starts with ``stage:`` for a stage, so no other span
  takes that prefix;
- ``pass:<stage>.<pass>``: the passes inside a stage (:func:`span`);
- ``wait:<site>``: each place in the frame path where the host blocks on
  the card: every upload of host values goes through :func:`to_device`.

Off, :func:`span` and :func:`frame` cost one flag check
and return a shared no-op context, and :func:`to_device` is
``torch.as_tensor``. On (:func:`enable`), a span opens a
``record_function`` range of its name, so the profiler places it and
the device work it launches on its own timeline, and keeps a
:class:`Span` record in memory: name, parent, frame index, start and end
on ``time.perf_counter_ns``, and its counters. Records are grouped by
frame and read back with :func:`frames`; nothing is written while a
frame runs.

The counter, on only:

- ``syncs``: host synchronisations with the card, as torch reports them
  with ``torch.cuda.set_sync_debug_mode("warn")`` (a copy between host
  and card that blocks, ``.item()``, ``.cpu()``, ``nonzero``; an
  explicit ``torch.cuda.synchronize`` is not reported). Each is counted
  on the innermost open ``wait:`` span; one outside every ``wait:`` span
  becomes a zero-length ``wait:unnamed`` record under the innermost open
  span, with ``at``, the package's innermost call place.

Spans and counters launch nothing on the card. The one place a span
records CUDA events is a timed stage span (``stage(..., timed=True)``,
``EffectComposer.collect_timings``), read by :func:`stage_ms`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time
import warnings

import torch

#: the text torch's sync debug mode warns with
SYNC_MESSAGE = "called a synchronizing CUDA operation"

_PKG = os.path.dirname(os.path.abspath(__file__))
_NULL = contextlib.nullcontext()

_ON = False
_stack: list = []           # open (record, index in its group)
_groups: list = []          # each a list of Span: a top-level span and all inside it
_frame_index = None         # the open frame span's index
_warnings = None            # enable()'s warnings.catch_warnings
_sync_mode = 0              # torch's sync debug mode before enable()


@dataclasses.dataclass
class Span:
    """One closed (or still open: ``end_ns`` 0) span."""

    name: str
    parent: int                 # index of the enclosing span in the frame's list; -1 at top
    frame: int | None           # the enclosing frame span's index; None outside any
    start_ns: int
    end_ns: int = 0
    counters: dict = dataclasses.field(default_factory=dict)

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


def enabled() -> bool:
    return _ON


def enable():
    """Turn spans and counters on; on a CUDA build, switch torch's sync
    debug mode to ``warn`` and take its warnings in (other warnings go
    where they went)."""
    global _ON, _warnings, _sync_mode
    if _ON:
        return
    _ON = True
    if not torch.cuda.is_available():
        return
    _warnings = warnings.catch_warnings()
    _warnings.__enter__()
    shown = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if str(message).startswith(SYNC_MESSAGE):
            _on_sync()
        else:
            shown(message, category, filename, lineno, file, line)

    warnings.filterwarnings("always", message=SYNC_MESSAGE)
    warnings.showwarning = show
    _sync_mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")


def disable():
    """Turn spans and counters off; the records stay until :func:`clear`."""
    global _ON, _warnings
    if not _ON:
        return
    _ON = False
    if _warnings is not None:
        torch.cuda.set_sync_debug_mode(_sync_mode)
        _warnings.__exit__(None, None, None)
        _warnings = None


def frames() -> list:
    """The records so far: one list a frame (or a top-level span opened
    outside any frame), each in opening order, its top span first."""
    return [list(g) for g in _groups]


def clear():
    """Drop every record (an open span keeps its place)."""
    del _groups[:-1 if _stack else None]


def _open(name: str) -> Span:
    if not _stack:
        _groups.append([])
    group = _groups[-1]
    rec = Span(name, _stack[-1][1] if _stack else -1, _frame_index,
               time.perf_counter_ns())
    _stack.append((rec, len(group)))
    group.append(rec)
    return rec


def _close(rec: Span):
    rec.end_ns = time.perf_counter_ns()
    _stack.pop()


class _Span:
    """A span with tracing on: a ``record_function`` range and a record."""

    __slots__ = ("name", "index", "range", "rec")

    def __init__(self, name: str, index=None):
        self.name = name
        self.index = index

    def __enter__(self) -> Span:
        global _frame_index
        if self.index is not None:
            _frame_index = self.index
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.rec = _open(self.name)
        return self.rec

    def __exit__(self, *exc):
        global _frame_index
        _close(self.rec)
        self.range.__exit__(*exc)
        if self.index is not None:
            _frame_index = None
        return False


def span(name: str):
    """A ``pass:`` span (or any span but a stage's): ``with span(name):``.
    Give ``name`` as a constant, so that the off path builds nothing."""
    if not _ON:
        return _NULL
    return _Span(name)


def frame(index: int):
    """The ``frame`` span of the frame with index ``index``."""
    if not _ON:
        return _NULL
    return _Span("frame", index)


def to_device(values, device, dtype=None, site: str = "upload") -> torch.Tensor:
    """``torch.as_tensor(values, dtype=dtype, device=device)``. With
    tracing on and host values, inside a ``wait:<site>`` span: a copy
    from pageable host memory ends with a stream synchronisation, so the
    host waits there for the card's queue to drain."""
    if not _ON or (torch.is_tensor(values) and values.device.type != "cpu"):
        return torch.as_tensor(values, dtype=dtype, device=device)
    with _Span("wait:" + site):
        return torch.as_tensor(values, dtype=dtype, device=device)


class _Stage:
    """A ``stage:<name>`` span: a ``record_function`` range always; with
    ``timed``, a pair of marks (CUDA events on the card, the host clock
    elsewhere) around it; with tracing on, a record."""

    __slots__ = ("name", "device", "timed", "range", "rec", "t0", "t1")

    def __init__(self, name: str, device, timed: bool):
        self.name = name
        self.device = device
        self.timed = timed
        self.rec = None

    def _mark(self):
        if self.device is not None and self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def __enter__(self):
        if self.timed:
            self.t0 = self._mark()
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        if _ON:
            self.rec = _open(self.name)
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            _close(self.rec)
        self.range.__exit__(*exc)
        if self.timed:
            self.t1 = self._mark()
        return False


def stage(name: str, device=None, timed: bool = False) -> _Stage:
    """The ``stage:<name>`` span of a composer stage on ``device``."""
    return _Stage("stage:" + name, device, timed)


def stage_ms(stages) -> dict:
    """{stage name: ms} of timed stage spans: the card's time between
    each span's two events (after one synchronisation), or the host
    clock's."""
    if any(not isinstance(s.t0, float) for s in stages):
        torch.cuda.synchronize()
    out = {}
    for s in stages:
        key = s.name[len("stage:"):]
        out[key] = (s.t0.elapsed_time(s.t1) if not isinstance(s.t0, float)
                    else (s.t1 - s.t0) * 1e3)
    return out


def _call_place() -> str:
    """``<file under the package>:<line>`` of the innermost frame of the
    package outside this module."""
    f = sys._getframe(1)
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(_PKG) and not path.endswith("tracing.py"):
            return f"{os.path.relpath(path, _PKG)}:{f.f_lineno}"
        f = f.f_back
    return "outside the package"


def _on_sync():
    """One host synchronisation with the card, as torch reported it."""
    if not _ON:
        return
    for rec, _ in reversed(_stack):
        if rec.name.startswith("wait:"):
            rec.counters["syncs"] = rec.counters.get("syncs", 0) + 1
            return
    rec = _open("wait:unnamed")
    rec.counters.update(syncs=1, at=_call_place())
    _stack.pop()
    rec.end_ns = rec.start_ns
