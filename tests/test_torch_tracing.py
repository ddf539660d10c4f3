"""``realism_effects_tpu_torch.tracing``: off, a frame leaves no record
and renders bit for bit what it renders on; on, one ``frame`` span a
render with the stages, passes and waits nested in it; ``to_device`` is
``torch.as_tensor``; the sync counter (CPU: the CUDA calls are stood in
for); the allocator's statistics are left alone."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from realism_effects_tpu_torch import analytic, tracing
from realism_effects_tpu_torch.effects.ao import HBAOEffect
from realism_effects_tpu_torch.effects.traa import TRAAEffect

H, W = 24, 32

SSGI_PASSES = {"setup", "prewarp", "trace", "shade", "reproject", "denoise", "compose"}
MOTION_BLUR_PASSES = {"setup", "accumulate", "resolve"}


@pytest.fixture(autouse=True)
def _off():
    """Every test starts and ends with tracing off and no records."""
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def _composer(stack: str):
    if stack == "flagship":
        return analytic.flagship_composer(H, W, "cpu")
    if stack == "flagship_march":
        return analytic.flagship_march_composer(H, W, "cpu")
    comp, cam = analytic.flagship_composer(H, W, "cpu")
    comp.effects = []
    comp.add_effect(HBAOEffect())
    comp.add_effect(TRAAEffect())
    return comp, cam


def _state(comp):
    return {e.name: comp.state(e.name) for e in comp.effects}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


@pytest.mark.parametrize("stack", ["hbao_traa", "flagship", "flagship_march"])
def test_off_leaves_nothing_and_on_changes_nothing(stack):
    torch.set_num_threads(1)
    off, cam_off = _composer(stack)
    on, cam_on = _composer(stack)
    for f in range(3):
        analytic.orbit(cam_off, f)
        a = off.render(dt=1 / 60)
        assert len(tracing.frames()) == f
        analytic.orbit(cam_on, f)
        tracing.enable()
        b = on.render(dt=1 / 60)
        tracing.disable()
        assert torch.equal(a, b)
        for x, y in zip(_leaves(_state(off)), _leaves(_state(on)), strict=True):
            assert torch.equal(x, y)
    assert len(tracing.frames()) == 3


def test_spans_of_a_frame():
    comp, cam = _composer("flagship")
    tracing.enable()
    for f in range(2):
        analytic.orbit(cam, f)
        comp.render(dt=1 / 60)
    tracing.disable()
    frames = tracing.frames()
    assert [g[0].name for g in frames] == ["frame", "frame"]
    for index, spans in enumerate(frames):
        top = spans[0]
        assert top.parent == -1 and top.frame == index
        assert all(s.frame == index for s in spans)
        assert all(s.end_ns >= s.start_ns for s in spans)
        children = {}
        for i, s in enumerate(spans[1:], 1):
            assert 0 <= s.parent < i
            outer = spans[s.parent]
            assert outer.start_ns <= s.start_ns and s.end_ns <= outer.end_ns
            children.setdefault(s.parent, []).append(s)
        for i, s in enumerate(spans):   # self times are not negative
            assert s.end_ns - s.start_ns >= sum(c.end_ns - c.start_ns
                                                for c in children.get(i, []))
        stages = [s for s in spans if s.name.startswith("stage:")]
        assert [s.name for s in stages] == ["stage:raster", "stage:ssgi", "stage:hbao",
                                            "stage:motion_blur", "stage:traa"]
        assert all(s.parent == 0 for s in stages)
        for stage, names in (("ssgi", SSGI_PASSES), ("motion_blur", MOTION_BLUR_PASSES)):
            idx = next(i for i, s in enumerate(spans) if s.name == f"stage:{stage}")
            passes = [s for s in spans if s.name.startswith(f"pass:{stage}.")]
            assert {s.name.split(".", 1)[1] for s in passes} == names
            assert all(s.parent == idx for s in passes)
        # the raster's uploads are waits inside its upload pass
        waits = [s for s in spans if s.name.startswith("wait:composer.")]
        assert {s.name for s in waits} == {"wait:composer.model_matrices",
                                           "wait:composer.prev_model_matrices"}
        assert all(spans[s.parent].name == "pass:raster.upload" for s in waits)
        assert all(s.counters == {} for s in waits)   # the CPU makes no syncs
        assert not any(s.name.startswith("stage:") for s in spans
                       if s.name not in {x.name for x in stages})


def test_spans_of_a_march_taps_frame():
    """Upstream's per-pixel stack: the march's launches in
    ``pass:ssgi.march`` inside ``pass:ssgi.trace``, the taps in
    ``pass:motion_blur.taps``, no pass of the sweep modes; each pass and
    the march lie inside their stage, and a stage's passes do not add up
    to more than the stage."""
    comp, cam = _composer("flagship_march")
    tracing.enable()
    analytic.orbit(cam, 0)
    comp.render(dt=1 / 60)
    tracing.disable()
    (spans,) = tracing.frames()
    names = [s.name for s in spans]
    idx = {n: names.index(n) for n in names}
    ssgi = {n.split(".", 1)[1] for n in names if n.startswith("pass:ssgi.")}
    assert ssgi == SSGI_PASSES - {"prewarp"} | {"march"}
    assert names.count("pass:ssgi.march") == 1
    assert spans[idx["pass:ssgi.march"]].parent == idx["pass:ssgi.trace"]
    assert spans[idx["pass:ssgi.trace"]].parent == idx["stage:ssgi"]
    blur = [s for s in spans if s.name.startswith("pass:motion_blur.")]
    assert [s.name for s in blur] == ["pass:motion_blur.taps"]
    assert blur[0].parent == idx["stage:motion_blur"]
    for i, s in enumerate(spans):
        inner = [c for c in spans if c.parent == i]
        assert all(s.start_ns <= c.start_ns and c.end_ns <= s.end_ns for c in inner)
        assert s.end_ns - s.start_ns >= sum(c.end_ns - c.start_ns for c in inner)


@pytest.mark.parametrize("values,dtype", [
    (np.eye(4)[None], torch.float32),
    (np.arange(6, dtype=np.float32), None),
    ([0.25, 1.0 / 3.0], None),
    ((1.0, 2.0, 3.0), torch.float64),
    (np.array([True, False]), None),
])
def test_to_device_is_as_tensor(values, dtype):
    want = torch.as_tensor(values, dtype=dtype, device="cpu")
    got = tracing.to_device(values, "cpu", dtype, site="test.upload")
    assert got.dtype == want.dtype and got.device == want.device
    assert torch.equal(got, want)
    assert tracing.frames() == []
    tracing.enable()
    again = tracing.to_device(values, "cpu", dtype, site="test.upload")
    tracing.disable()
    assert torch.equal(again, want) and again.dtype == want.dtype
    (rec,), = tracing.frames()
    assert rec.name == "wait:test.upload" and rec.parent == -1
    assert rec.counters == {}


def test_a_sync_outside_every_wait_is_unnamed():
    tracing._on_sync()                      # off: nothing
    assert tracing.frames() == []
    tracing.enable()
    with tracing.frame(7):
        with tracing.span("pass:test.outer"):
            tracing._on_sync()
            with tracing._Span("wait:test.site"):
                tracing._on_sync()
                tracing._on_sync()
    tracing.disable()
    (spans,) = tracing.frames()
    names = [s.name for s in spans]
    assert names == ["frame", "pass:test.outer", "wait:unnamed", "wait:test.site"]
    unnamed = spans[2]
    assert unnamed.parent == 1 and unnamed.frame == 7 and unnamed.ms == 0.0
    assert unnamed.counters["syncs"] == 1
    assert unnamed.counters["at"] == "outside the package"   # called from this test
    assert spans[3].counters == {"syncs": 2}
    assert sum(s.counters.get("syncs", 0) for s in spans) == 3


def test_sync_warnings_are_taken_in(monkeypatch):
    """With tracing on, torch's sync warning is counted and not shown;
    another warning still reaches the previous handler."""
    shown = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: shown.append(mode))
    import warnings

    tracing.enable()
    try:
        with tracing._Span("wait:test.read_back"):
            warnings.warn(tracing.SYNC_MESSAGE)
            warnings.warn(tracing.SYNC_MESSAGE)
        with pytest.warns(UserWarning, match="something else"):
            warnings.warn("something else")
    finally:
        tracing.disable()
    assert shown == ["warn", 0]
    (spans,) = tracing.frames()
    assert spans[0].counters == {"syncs": 2}


def test_tracing_leaves_the_allocator_alone(monkeypatch):
    """With tracing on, a frame neither reads nor resets the allocator's
    statistics, so a caller's ``torch.cuda.max_memory_allocated`` keeps
    its meaning."""
    def touched(*a, **k):
        raise AssertionError("tracing touched the allocator's statistics")

    for name in ("memory_stats", "memory_stats_as_nested_dict", "max_memory_allocated",
                 "reset_peak_memory_stats", "reset_max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, touched)
    comp, cam = _composer("flagship")
    tracing.enable()
    with tracing.stage("outer", torch.device("cpu")):
        analytic.orbit(cam, 0)
        comp.render(dt=1 / 60)
    tracing.disable()
    assert [g[0].name for g in tracing.frames()] == ["stage:outer"]
    assert all(s.counters == {} for s in tracing.frames()[0])


def test_stage_ranges_stay_when_off_and_passes_join_when_on(tmp_path):
    """The profiler sees the ``stage:`` ranges with tracing off and no
    other span, and so does ``profile()``, which leaves tracing as it
    is; with tracing on, its trace carries the ``frame``, ``pass:`` and
    ``wait:`` ranges too."""
    comp, cam = _composer("hbao_traa")
    analytic.orbit(cam, 0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        comp.render(dt=1 / 60)
    names = {e.name for e in prof.events()}
    assert {"stage:raster", "stage:hbao", "stage:traa"} <= names
    assert not any(n == "frame" or n.startswith(("pass:", "wait:")) for n in names)
    with open(comp.profile(str(tmp_path / "stages"), frames=1)) as f:
        events = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"stage:raster", "stage:hbao", "stage:traa"} <= events
    assert not any(n == "frame" or n.startswith(("pass:", "wait:")) for n in events
                   if n)
    assert tracing.frames() == []
    assert not tracing.enabled()
    tracing.enable()
    path = comp.profile(str(tmp_path), frames=1)
    assert tracing.enabled()
    tracing.disable()
    with open(path) as f:
        events = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"frame", "stage:hbao", "pass:hbao.ao", "pass:traa.reproject",
            "wait:composer.model_matrices"} <= events
    assert [g[0].name for g in tracing.frames()] == ["frame"]


def test_collect_timings_reads_the_stage_spans():
    comp, cam = _composer("hbao_traa")
    comp.collect_timings = True
    analytic.orbit(cam, 0)
    comp.render(dt=1 / 60)
    t = comp.last_timings
    assert set(t) == {"raster", "hbao", "traa"} and all(v >= 0.0 for v in t.values())
    assert tracing.frames() == []
    comp.collect_timings = False
    comp.render(dt=1 / 60)
    assert comp.last_timings == {}
