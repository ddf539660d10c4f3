"""The benchmark's ``flagship_march-1080p-orbit`` cell on the CPU at a
tiny size: the manifest resolves it to upstream's per-pixel stack (SSGI's
march, motion blur's taps) with the limits of the mode references
(``port_bench/reference/stages/ssgi_trace_march.py``,
``motion_blur_taps.py``) in place of the sweeps', and a whole run
(``port_bench.run.run_cell``: the program, the window, the comparison
with the plain reference ``reference/port`` and the stage references)
comes out correct."""

import time

import pytest
import torch

from port_bench import manifest, run, trace
from port_bench.roofline import least_s

CELL = "flagship_march-1080p-orbit"


@pytest.fixture
def cell():
    c = manifest.resolve(CELL)
    c.traffic.update(width=96, height=54, warmup_frames=2,
                     trace={"synced_frames": 2, "profiled_frames": 2})
    return c


def test_the_cell_is_the_per_pixel_stack(cell):
    options = {e["effect"]: e["options"] for e in cell.config["stack"]}
    assert options["SSGIEffect"] == {"trace": "march"}
    assert options["MotionBlurEffect"] == {"mode": "taps"}
    assert cell.chips == 1 and cell.config["reduced"] == []
    limits = cell.traffic["compare"]["limits"]
    assert limits["stages.ssgi_trace_march_mean"] == 5e-5
    assert limits["stages.motion_blur_taps_mean"] == 2e-5
    assert not {"stages.ssgi_trace_mean", "stages.motion_blur_mean"} & set(limits)
    kernels = {e["kernel"] for e in cell.traffic["kernel_launches"]}
    assert {"ray_march_kernel", "motion_blur_taps_kernel"} <= kernels
    assert not {"sweep_kernel", "motion_blur_kernel"} & kernels
    assert {m["name"] for m in cell.per_layer} == {
        "pass_busy_ms.ssgi.march", "pass_busy_ms.motion_blur.taps",
        "ray_march_kernel_roofline", "motion_blur_taps_kernel_roofline"}


def test_a_run_on_the_cpu_is_correct(cell):
    torch.set_num_threads(1)
    result = run.run_cell(cell, 2 ** 32 + 11, 0.3, False, torch.device("cpu"),
                          time.perf_counter())
    checks = result["checks"]
    assert result["correct"], checks
    assert {"stages.ssgi_trace_march_mean", "stages.motion_blur_taps_mean"} <= set(checks)
    assert checks["stages.motion_blur_taps_mean"]["value"] == 0.0
    assert set(result["metrics"]) == {"frame_ms", "peak_mem_mib", "setup_s"}


def _traced(cell, ops):
    """A reader's context over a made-up profile of two frames, the
    program's traced pass already run and empty."""
    ctx = run.Traced(cell, 100.0, [90.0, 95.0], trace.DeviceTrace(
        frames=2, window_s=0.2, ops=ops, stages=[], host_stages=[]))
    ctx.program_trace = None
    return ctx


def test_the_new_readers_read_nothing_from_a_program_without_the_kernels(cell):
    """A program without the kernels and spans (the parent's): every new
    metric is None, so the result line leaves it out."""
    ctx = _traced(cell, [("void sweep_kernel<true>(float const*)", 0.0, 300.0),
                         ("void motion_blur_kernel(float const*)", 400.0, 50.0)])
    for m in cell.per_layer:
        assert cell.reader(m["name"]).read(ctx) is None, m["name"]


@pytest.mark.parametrize("kernel", ["ray_march_kernel", "motion_blur_taps_kernel"])
def test_a_kernel_share_is_its_rows_over_its_time(cell, kernel):
    name = f"(anonymous namespace)::{kernel}(float const*, float*)"
    ctx = _traced(cell, [(name, 0.0, 80.0), ("void hbao_kernel(float const*)", 90.0, 5.0),
                         (name, 1000.0, 120.0)])
    mod = manifest.load_module("kernels", kernel, cell.base)
    least = sum(e["count"] * least_s(*mod.cost(e["params"]))
                for e in cell.traffic["kernel_launches"] if e["kernel"] == kernel)
    got = cell.reader(f"{kernel}_roofline").read(ctx)
    assert got == pytest.approx(100.0 * least / 100e-6)
