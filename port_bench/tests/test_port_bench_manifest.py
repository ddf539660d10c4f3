"""The manifest: every name resolves to its files, names and units keep
to their characters, and a new cell needs only new files."""

import json
import re
import shutil
from pathlib import Path

import pytest

from port_bench import manifest
from port_bench.manifest import HERE, ROOT, load_manifest, resolve

MANIFEST = load_manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _names():
    out = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        out += [(key, e["name"]) for e in MANIFEST[key]]
    out += [("traffic", w["traffic"]) for w in MANIFEST["workloads"]]
    out += [("config", w["config"]) for w in MANIFEST["workloads"]]
    out += [("reduced", k) for c in MANIFEST["configs"] for k in c["reduced"]]
    return out


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["port_bench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = resolve(cell)
    assert c.chips == 1
    assert (ROOT / next(x["file"] for x in MANIFEST["configs"]
                        if x["name"] == c.config["name"])).is_file()
    for m in c.per_layer:
        assert callable(c.reader(m["name"]).read)
    assert c.traffic["kernel_launches"], "the roofline's launch table"
    compare = c.traffic["compare"]
    assert compare["frames"] >= 2, "the replay steps the temporal state more than once"
    # every stage of the stack that has an independent reference is
    # compared: the raster, each effect by its name, and a tracing
    # effect's trace as ``<name>_trace`` (``check.Recorder``'s rule)
    from port_bench.check import stage_module
    from port_bench.reference import port as ref_pkg
    stages = ["raster"]
    for e in c.config["stack"]:
        effect = getattr(ref_pkg, e["effect"])(**e.get("options", {}))
        stages += [effect.name] + ([f"{effect.name}_trace"] if hasattr(effect, "trace") else [])
    for stage in stages:
        assert stage_module(stage) is not None, stage
        assert any(k.startswith(f"stages.{stage}_") for k in compare["limits"]), stage


@pytest.mark.parametrize("kind,name", _names())
def test_name_characters(kind, name):
    assert NAME.match(name), (kind, name)


@pytest.mark.parametrize("metric", MANIFEST["end_to_end"] + MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if metric in MANIFEST["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert "\n" not in metric["layer"] and 1 <= len(metric["layer"]) <= 200


def _cells_missing_what_it_moves(m: dict, metric: dict) -> list:
    """The cells in which manifest ``m`` reads the per-layer ``metric``
    that are not cells of ``m`` or do not report the end-to-end metric it
    moves."""
    cells = [w["name"] for w in m["workloads"]]
    moved = next(e for e in m["end_to_end"] if e["name"] == metric["moves"])
    return [cell for cell in metric.get("workloads", cells)
            if cell not in cells or not manifest._reports(moved, cell)]


@pytest.mark.parametrize("metric", MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_per_layer_cells_report_what_it_moves(metric):
    assert _cells_missing_what_it_moves(MANIFEST, metric) == [], metric


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    c = resolve(cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert "gpu_ms" in names, "every cell's device time, with no list to edit"
    assert c.per_layer


def test_configs_used_and_files_distinct():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(set(files)) == len(files)
    assert all(f.startswith("port_bench/") for f in files)


def test_a_new_cell_is_new_files_only(tmp_path):
    """A throwaway configuration, traffic mix, per-layer metric and
    kernel, written under ``tmp_path`` beside copies of the benchmark's
    own files, resolve by name with no edit to any existing file or
    entry; the cell reports a timing, ``gpu_ms``, which its per-layer
    metric moves."""
    base = tmp_path / "port_bench"
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (base / "configs" / "tiny_stack.json").write_text(json.dumps(dict(
        json.loads((HERE / "configs" / "hbao_traa.json").read_text()),
        name="tiny_stack", stack=[{"effect": "TRAAEffect", "options": {}}])))
    traffic = json.loads((HERE / "traffic" / "hbao_traa-1080p-orbit.json").read_text())
    traffic["kernel_launches"] = [{"kernel": "toy_kernel", "count": 2,
                                   "params": {"h": 4, "w": 4}}]
    (base / "traffic" / "tiny-orbit.json").write_text(json.dumps(traffic))
    (base / "metrics" / "toy_metric.py").write_text("def read(ctx):\n    return 1.0\n")
    (base / "kernels" / "toy_kernel.py").write_text(
        "NAME = 'toy_kernel'\n\ndef cost(p):\n    return p['h'] * p['w'] * 8, 0\n")
    m = dict(MANIFEST)
    m["configs"] = MANIFEST["configs"] + [{
        "name": "tiny_stack", "source": "https://example.org", "reduced": [],
        "file": "port_bench/configs/tiny_stack.json", "why": "a test"}]
    m["workloads"] = MANIFEST["workloads"] + [{
        "name": "tiny-orbit", "config": "tiny_stack", "traffic": "tiny-orbit",
        "chips": 1, "why": "a test"}]
    m["per_layer"] = MANIFEST["per_layer"] + [{
        "name": "toy_metric", "unit": "ms", "better": "lower", "source": "host_clock",
        "layer": "toy", "moves": "gpu_ms", "workloads": ["tiny-orbit"]}]
    cell = resolve("tiny-orbit", manifest=m, root=tmp_path, base=base)
    assert {e["name"] for e in cell.end_to_end} == {"gpu_ms", "peak_mem_mib", "setup_s"}
    for metric in m["per_layer"]:
        assert _cells_missing_what_it_moves(m, metric) == [], metric
    assert [e["effect"] for e in cell.config["stack"]] == ["TRAAEffect"]
    assert [p["name"] for p in cell.per_layer] == ["toy_metric"]
    assert cell.reader("toy_metric").read(None) == 1.0
    assert manifest.load_module("kernels", "toy_kernel", base).cost({"h": 4, "w": 4}) == (128, 0)
