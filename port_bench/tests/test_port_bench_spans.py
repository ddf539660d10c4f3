"""The readers of the program's spans and counters (``spans.py``) on a
made-up traced pass, in the style of ``test_port_bench_harness._trace``:
waits, host work, idle after waits, per-pass device time, the gap
labels, and what the pass reads from a profile."""

from types import SimpleNamespace

import pytest
import torch

from port_bench import manifest, run, spans, trace

SSGI = ("setup", "prewarp", "trace", "shade", "reproject", "denoise", "compose")
MOTION_BLUR = ("setup", "accumulate", "resolve")


def _span(name, ms, **counters):
    return SimpleNamespace(name=name, ms=ms, counters=counters)


def _program_trace():
    # two synced frames: 3 waits (one unnamed) and 1.5 ms waiting in the
    # first, 1 wait and 0.5 ms in the second
    synced = [
        [_span("frame", 10.0), _span("stage:raster", 4.0),
         _span("wait:composer.model_matrices", 1.0, syncs=1),
         _span("wait:motion_blur.px", 0.5, syncs=1),
         _span("wait:unnamed", 0.0, syncs=1, at="ops/x.py:1")],
        [_span("frame", 8.0), _span("wait:composer.model_matrices", 0.5, syncs=1)],
    ]
    # two profiled frames, us: passes on the device, spans on the host
    ops = [("void sweep_kernel(float const*)", 0.0, 100.0),
           ("elementwise_kernel", 100.0, 20.0),
           ("Memcpy HtoD (Pageable -> Device)", 300.0, 2.0),
           ("elementwise_kernel", 302.0, 50.0),
           ("elementwise_kernel", 600.0, 30.0)]
    passes = [(0.0, 100.0, "ssgi.trace"), (100.0, 130.0, "ssgi.shade"),
              (302.0, 360.0, "motion_blur.setup")]
    host = [(-100.0, 700.0, "frame"), (-90.0, 115.0, "stage:ssgi"),
            (-80.0, 100.0, "pass:ssgi.trace"), (100.0, 115.0, "pass:ssgi.shade"),
            (115.0, 400.0, "stage:motion_blur"), (116.0, 380.0, "pass:motion_blur.setup"),
            (118.0, 301.0, "wait:motion_blur.px")]
    dt = trace.DeviceTrace(frames=2, window_s=0.002, ops=ops, stages=passes,
                           host_stages=host)
    return spans.ProgramTrace(synced, dt)


def _ctx(cell_name="flagship-1080p-orbit"):
    cell = manifest.resolve(cell_name)
    ctx = run.Traced(cell, 1.0, [7.0, 9.0], trace.DeviceTrace(2, 0.001, [], [], []))
    ctx.program_trace = _program_trace()
    return cell, ctx


def test_host_readers():
    cell, ctx = _ctx()
    read = lambda name: cell.reader(name).read(ctx)
    assert read("host_waits_per_frame") == pytest.approx(2.0)
    assert read("host_wait_ms") == pytest.approx(1.0)
    # phase 2's 8 ms a frame less the waits, not the traced frames' 9
    assert read("host_work_ms") == pytest.approx(7.0)


def test_idle_after_wait():
    cell, ctx = _ctx()
    # the gaps start at 120 (180 us, the host inside the wait) and 352
    # (248 us, the host in pass:motion_blur.setup; the copy ends where
    # the next op starts): only the first follows a wait
    assert cell.reader("idle_after_wait_ms").read(ctx) == pytest.approx(0.18 / 2)


def test_pass_readers():
    cell, ctx = _ctx()
    got = {p: cell.reader(f"pass_busy_ms.ssgi.{p}").read(ctx) for p in SSGI}
    assert got["trace"] == pytest.approx(0.05)
    assert got["shade"] == pytest.approx(0.01)
    assert all(got[p] is None for p in SSGI if p not in ("trace", "shade"))
    # the copy started before the pass's device range: it falls outside
    mb = {p: cell.reader(f"pass_busy_ms.motion_blur.{p}").read(ctx) for p in MOTION_BLUR}
    assert mb == {"setup": pytest.approx(0.025), "accumulate": None, "resolve": None}


def test_stage_extents():
    _, ctx = _ctx()
    dt = spans.stage_extents(ctx.program_trace.profiled)
    assert dt.stages == [(0.0, 130.0, "ssgi"), (302.0, 360.0, "motion_blur")]
    assert trace.stage_busy_ms(dt) == pytest.approx({"ssgi": 0.06, "motion_blur": 0.025})


def test_gap_labels():
    _, ctx = _ctx()
    gaps = spans.idle_gaps_by_span(ctx.program_trace.profiled)
    assert gaps == [["pass:motion_blur.setup", pytest.approx(248e-6)],
                    ["wait:motion_blur.px", pytest.approx(180e-6)]]
    dt = trace.DeviceTrace(1, 0.0, [("a", 0.0, 1.0), ("b", 5.0, 1.0)], [], [])
    assert spans.idle_gaps_by_span(dt) == [["between spans", pytest.approx(4e-6)]]


def test_read_profile():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    ev = lambda name, dev, a, b: SimpleNamespace(
        name=name, device_type=dev, time_range=SimpleNamespace(start=a, end=b))
    prof = SimpleNamespace(events=lambda: [
        ev("frame", cpu, 0.0, 100.0), ev("frame", cuda, 10.0, 90.0),
        ev("stage:ssgi", cpu, 1.0, 50.0), ev("stage:ssgi", cuda, 10.0, 40.0),
        ev("pass:ssgi.trace", cpu, 2.0, 20.0), ev("pass:ssgi.trace", cuda, 10.0, 30.0),
        ev("wait:composer.model_matrices", cuda, 5.0, 6.0),
        ev("aten::add", cpu, 3.0, 4.0), ev("void k()", cuda, 20.0, 30.0),
        ev("void j()", cuda, 10.0, 15.0)])
    dt = spans.read_profile(prof, 1, 0.01)
    assert dt.ops == [("void j()", 10.0, 5.0), ("void k()", 20.0, 10.0)]
    assert dt.stages == [(10.0, 30.0, "ssgi.trace")]
    assert [r[2] for r in dt.host_stages] == ["frame", "stage:ssgi", "pass:ssgi.trace"]


def test_nothing_read_without_a_profile_or_the_module(monkeypatch):
    cell = manifest.resolve("hbao_traa-1080p-orbit")
    empty = run.Traced(cell, 1.0, [], trace.DeviceTrace(2, 0.0, [], [], []))
    assert spans.get(empty) is None and empty.program_trace is None
    profiled = run.Traced(cell, 1.0, [], trace.DeviceTrace(2, 0.0, [("k", 0.0, 1.0)], [], []))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(spans.importlib.util, "find_spec", lambda name: None)
    assert spans.get(profiled) is None
    for m in cell.per_layer:
        if m["source"].startswith("program_"):
            assert cell.reader(m["name"]).read(profiled) is None, m["name"]


def test_the_seed_comes_from_the_command_line(monkeypatch):
    monkeypatch.setattr(spans.sys, "argv", ["run.py", "--workload", "x", "--seed", "4294967296"])
    assert spans._seed() == 2 ** 32
    monkeypatch.setattr(spans.sys, "argv", ["run.py", "--workload", "x"])
    with pytest.raises(RuntimeError, match="--seed"):
        spans._seed()
