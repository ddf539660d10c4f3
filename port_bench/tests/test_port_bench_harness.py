"""The harness's refusals and its readers: no card, no result; the
modules no run may load, by whole top-level name; the per-layer readers
on a made-up trace; ``gpu_ms``; each kernel's bytes and operations; the
stack SSR -> GTAO -> TAA, which no cell registers yet, built and run end
to end."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from port_bench import manifest, run, trace
from port_bench.inputs import Inputs
from port_bench.manifest import ROOT, load_manifest
from port_bench.reference import port as ref_pkg
from port_bench.rig import Rig
from port_bench.roofline import least_s, matches
from port_bench.tests.test_port_bench_stages import ssr_gtao_taa


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    done = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                           "hbao_traa-1080p-orbit", "--seed", str(2 ** 31 + 3),
                           "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode != 0
    assert done.stdout.strip() == ""
    assert "CUDA device" in done.stderr


@pytest.mark.parametrize("name,banned", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax", True),
    ("realism_effects_tpu", True), ("realism_effects_tpu.ops.pallas", True),
    ("bench", True), ("realism_effects_tpu_torch", False),
    ("realism_effects_tpu_torch.bench", False), ("benchmark", False), ("jaxtyping", False)])
def test_banned_names_compare_whole(name, banned, monkeypatch):
    monkeypatch.setitem(sys.modules, name, object())
    assert (name in run.banned_modules()) is banned


def test_what_a_run_imports():
    """Everything ``port_bench`` runs, imported in a fresh process, with
    the program: none of the banned top-level names."""
    code = ("import sys, realism_effects_tpu_torch, port_bench.run, port_bench.control; "
            "from port_bench import manifest; m = manifest.load_manifest(); "
            "[manifest.resolve(w['name']) for w in m['workloads']]; "
            "from port_bench.run import banned_modules; b = banned_modules(); "
            "print(b); sys.exit(1 if b else 0)")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stdout + done.stderr


def _trace():
    # two frames; stages on the device and the host; ops in us
    ops = [("void zscan_kernel<1>(float const*)", 0.0, 100.0),
           ("void hbao_kernel(float const*)", 150.0, 50.0),
           ("void hbao_noise_kernel(float const*)", 200.0, 10.0),
           ("Memcpy HtoD", 400.0, 40.0)]
    stages = [(0.0, 120.0, "raster"), (140.0, 300.0, "hbao")]
    host = [(-50.0, 130.0, "raster"), (130.0, 420.0, "hbao")]
    return trace.DeviceTrace(frames=2, window_s=0.001, ops=ops, stages=stages,
                             host_stages=host)


def test_trace_arithmetic():
    t = _trace()
    assert t.busy_s == pytest.approx(200e-6)
    assert trace.stage_busy_ms(t) == pytest.approx({"raster": 0.05, "hbao": 0.03})
    gaps = trace.idle_gaps(t)
    assert gaps[0] == ["stage:hbao", pytest.approx(190e-6)]
    assert gaps[1] == ["stage:raster", pytest.approx(50e-6)]
    assert trace.top_ops(t, 1) == [["void zscan_kernel<1>(float const*)", 100e-6]]


def test_readers_on_a_trace():
    cell = manifest.resolve("hbao_traa-1080p-orbit")
    ctx = run.Traced(cell, 0.25, [1.0, 3.0], _trace())
    read = lambda name: cell.reader(name).read(ctx)
    assert read("host_enqueue_ms") == pytest.approx(2.0)
    assert read("launches_per_frame") == pytest.approx(2.0)
    assert read("device_busy_ms") == pytest.approx(0.1)
    assert read("device_idle_share") == pytest.approx(60.0)
    assert read("stage_busy_ms.hbao") == pytest.approx(0.03)
    assert read("stage_busy_ms.traa") is None
    # the cell's own readers, beside its gpu_ms: the same arithmetic
    assert read("frame_ms.host_paced") == pytest.approx(0.25)
    assert read("stage_busy_ms.raster.gpu") == pytest.approx(0.05)
    assert read("stage_busy_ms.hbao.gpu") == pytest.approx(0.03)
    assert read("stage_busy_ms.traa.gpu") is None
    assert read("kernel_roofline_share.gpu") is None
    # the table's kernels lookup_kernel, poisson_kernel, ... are not in
    # this profile: the share is not read
    assert read("kernel_roofline_share") is None
    # every kernel of the table profiled, 10 us each over the 2 frames;
    # hbao_noise_kernel is not hbao_kernel and counts for nothing
    table = cell.traffic["kernel_launches"]
    names = sorted({manifest.load_module("kernels", e["kernel"]).NAME for e in table})
    ops = [(f"void {n}<4>(float const*)", 1000.0 + 20 * i, 10.0) for i, n in enumerate(names)]
    ops.append(("void hbao_noise_kernel(float const*)", 2000.0, 500.0))
    full = run.Traced(cell, 0.25, [], trace.DeviceTrace(2, 0.001, ops, [], []))
    least = sum(e["count"] * least_s(*manifest.load_module("kernels", e["kernel"]).cost(
        e["params"])) for e in table)
    for name in ("kernel_roofline_share", "kernel_roofline_share.gpu"):
        assert cell.reader(name).read(full) == pytest.approx(
            100 * least / (len(names) * 5e-6))
    # with nothing profiled, every reader but the window's wall time reads
    # nothing, in this cell and in the others
    empty = run.Traced(cell, 0.25, [], trace.DeviceTrace(2, 0.0, [], [], []))
    for m in load_manifest()["per_layer"]:
        want = 0.25 if m["name"] == "frame_ms.host_paced" else None
        assert cell.reader(m["name"]).read(empty) == want, m["name"]


def test_kernel_names_match_whole():
    assert matches("void hbao_kernel<8>(float const*)", "hbao_kernel")
    assert not matches("void hbao_noise_kernel(float const*)", "hbao_kernel")
    assert not matches("void warp_multi_kernel<4>(float const*)", "warp_kernel")
    assert matches("warp_kernel", "warp_kernel")


@pytest.mark.parametrize("cell", [w["name"] for w in load_manifest()["workloads"]])
def test_launch_tables(cell):
    c = manifest.resolve(cell)
    h, w = c.traffic["height"], c.traffic["width"]
    for e in c.traffic["kernel_launches"]:
        mod = manifest.load_module("kernels", e["kernel"])
        nbytes, ops = mod.cost(e["params"])
        assert (e["params"]["h"], e["params"]["w"]) == (h, w)
        assert nbytes > 0 and ops >= 0 and e["count"] >= 1
    # a 1080p warp of 4 channels in catrom5: chip_smoke.py's count
    b, o = manifest.load_module("kernels", "warp_kernel").cost(
        {"h": 1080, "w": 1920, "c": 4, "mode": "catrom5"})
    px = 1080 * 1920
    assert (b, o) == (px * (16 + 8 + 8 + 16 + 1), px * (4 * 32 + 30))


@pytest.mark.parametrize("side", ["program", "reference"])
def test_a_rig_builds_ssr_gtao_taa(side, tiny):
    """Each package builds the three effects from the configuration's
    stack by their names."""
    import realism_effects_tpu_torch as program

    pkg = program if side == "program" else ref_pkg
    c = ssr_gtao_taa(tiny("hbao_traa-1080p-orbit"))
    rig = Rig(pkg, c, Inputs(c, 2 ** 31 + 5), torch.device("cpu"))
    assert [type(e) for e in rig.comp.effects] == [pkg.SSREffect, pkg.GTAOEffect, pkg.TAAPass]
    assert rig.state_names == ["__global__", "ssr", "gtao", "taa"]


def test_a_tiny_run_of_ssr_gtao_taa_is_correct(tiny):
    """The program's warm-up and window against the plain reference, on
    the CPU at a tiny size: the start and last frames and the four new
    stage numbers within their limits."""
    torch.set_num_threads(1)
    c = ssr_gtao_taa(tiny("hbao_traa-1080p-orbit"))
    result = run.run_cell(c, 2 ** 32 + 29, 0.0, False, torch.device("cpu"),
                          time.perf_counter())
    checks = result["checks"]
    assert result["correct"], checks
    assert set(checks) == set(c.traffic["compare"]["limits"])
    assert {f"stages.{s}_mean" for s in ("ssr_trace", "ssr", "gtao", "taa")} <= set(checks)


@pytest.mark.parametrize("name,reported", [
    ("hbao_traa-1080p-orbit", {"gpu_ms", "peak_mem_mib", "setup_s"}),
    ("flagship-1080p-orbit", {"frame_ms", "gpu_ms", "peak_mem_mib", "setup_s"})])
def test_gpu_ms_is_the_profiled_frames_busy_time(name, reported, tiny, monkeypatch):
    """Every cell reports ``gpu_ms``: an untraced run profiles the traffic
    file's frames once, after the window, and reports their device ms a
    frame. ``frame_ms`` is reported beside it where the cell lists it (the
    flagship's, not HBAO + TRAA's); on the CPU no CUDA event times a
    frame, so ``frame_ms_p95`` is not."""
    torch.set_num_threads(1)
    c = tiny(name)
    calls = []

    def fake(rig, cell, first, device):
        calls.append(first)
        return trace.DeviceTrace(2, 0.001, [("k", 0.0, 1500.0), ("m", 2000.0, 500.0)], [], [])
    monkeypatch.setattr(run, "profiled", fake)
    result = run.run_cell(c, 2 ** 32 + 31, 0.0, False, torch.device("cpu"),
                          time.perf_counter())
    assert result["correct"], result["checks"]
    assert len(calls) == 1 and calls[0] > c.traffic["warmup_frames"]
    assert set(result["metrics"]) == reported
    assert result["metrics"]["gpu_ms"] == {"value": pytest.approx(1.0), "unit": "ms/frame"}


@pytest.mark.card
def test_one_short_run_on_the_card(card):
    done = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                           "hbao_traa-1080p-orbit", "--seed", "5", "--seconds", "1",
                           "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    assert done.returncode == 0, done.stderr[-4000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
