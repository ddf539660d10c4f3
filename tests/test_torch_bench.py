"""The port's bench (``realism_effects_tpu_torch/bench.py``) on the CPU.

Its scenes, stacks and motions against the JAX package's ``bench.py``,
which is loaded by path and only builds them here (nothing JAX-side is
rendered): the packed scene arrays, the model matrices, the lighting and
the camera matrices must be equal (the same numpy code builds them; the
camera's product matrix, which the JAX package multiplies in float32 on
its device, within 1e-6 as in ``tests/test_torch_core.py``), and so must
the effects' names and options and the composer's size. Then small runs
of the port's timing loop on the CPU (plain versions of the kernels),
its refusals, its byte counter, and its import rule.
"""

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from realism_effects_tpu_torch import analytic, bench
from realism_effects_tpu_torch.ops import cuda_build
from realism_effects_tpu_torch.scene.gltf import write_glb
from realism_effects_tpu_torch.scene.scene import _PACKED_DTYPES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ["raster_shade", "ssgi", "hbao", "motion_blur", "traa"]


@pytest.fixture(scope="module")
def jax_bench_module():
    spec = importlib.util.spec_from_file_location(
        "jax_root_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jbench(jax_bench_module, monkeypatch, tmp_path):
    """The JAX bench with its GLB round trip (config 1) under ``tmp_path``;
    the module attributes a test sets are restored after it."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return jax_bench_module


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_camera(jcam, tcam):
    jm, tm = jcam.matrices(), tcam.matrices()
    for f in ("projection_matrix", "projection_matrix_inverse", "view_matrix",
              "camera_matrix_world", "position"):
        np.testing.assert_array_equal(np.asarray(getattr(tm, f)),
                                      np.asarray(getattr(jm, f)), err_msg=f)
    np.testing.assert_allclose(tm.projection_view_matrix,
                               np.asarray(jm.projection_view_matrix),
                               rtol=1e-6, atol=1e-6)


def _same_scene(jscene, tscene):
    want, got = jscene.pack(), tscene.pack_arrays()
    for k in _PACKED_DTYPES:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(getattr(want, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(tscene.model_matrices(),
                                  np.asarray(jscene.model_matrices()))
    jl, tl = jscene.lighting_params(), tscene.lighting_params("cpu")
    assert set(jl) == set(tl)
    for k in jl:
        np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]), err_msg=k)


def _options(effect):
    """An effect's class name and its option values: plain attributes
    and its config dataclasses."""
    out = {"class": type(effect).__name__}
    for k, v in vars(effect).items():
        if isinstance(v, (bool, int, float, str, tuple)) or v is None:
            out[k] = v
        elif dataclasses.is_dataclass(v):
            out[k] = {f.name: getattr(v, f.name) for f in dataclasses.fields(v)
                      if isinstance(getattr(v, f.name),
                                    (bool, int, float, str, tuple, type(None)))}
    return out


def _same_composer(jcomp, tcomp):
    assert (tcomp.width, tcomp.height) == (jcomp.width, jcomp.height)
    assert [e.name for e in tcomp.effects] == [e.name for e in jcomp.effects]
    for je, te in zip(jcomp.effects, tcomp.effects):
        want, got = _options(je), _options(te)
        assert set(want) <= set(got), want["class"]
        assert {k: got[k] for k in want} == want, want["class"]
    _same_scene(jcomp.scene, tcomp.scene)


# ---------------------------------------------------------------------
# scenes, stacks and motions against the JAX bench
# ---------------------------------------------------------------------

@pytest.mark.parametrize("trace", ["sweep", "march"])
def test_flagship_matches_jax(jbench, monkeypatch, trace):
    """``build_composer`` and ``_orbit`` (0.01 rad a frame)."""
    monkeypatch.setattr(jbench, "WIDTH", 96)
    monkeypatch.setattr(jbench, "HEIGHT", 64)
    monkeypatch.setattr(jbench, "TRACE", trace)
    jcomp, jcam = jbench.build_composer()
    tcomp, tcam = bench.build_composer(96, 64, "cpu", trace)
    _same_composer(jcomp, tcomp)
    _same_camera(jcam, tcam)
    for f in (0, 7):
        jbench._orbit(jcam, f)
        bench._orbit(tcam, f)
        _same_camera(jcam, tcam)


@pytest.mark.parametrize("trace", ["sweep", "march"])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_config_matches_jax(jbench, monkeypatch, n, trace):
    """``build_config(n)`` at its own size: the scene (config 1's meshes
    loaded back from the GLB), the stack, the metric name, and for the
    animated configurations (3: the camera at 0.02 rad a frame; 5: the box
    and the camera) the scene and camera after ``animate(f)``."""
    monkeypatch.setattr(jbench, "TRACE", trace)
    jcomp, janim, jname = jbench.build_config(n)
    height, width = bench.CONFIG_SIZES[n]
    tcomp, tanim, tname = bench.build_config(n, width, height, "cpu", trace)
    assert tname == jname
    _same_composer(jcomp, tcomp)
    _same_camera(jcomp.camera, tcomp.camera)
    assert (janim is None) == (tanim is None) == (n in (1, 2, 4))
    if n == 1:
        assert "re_tpu_bench.glb" in os.listdir(tempfile.gettempdir())
    for f in (0, 7) if tanim else ():
        janim(f)
        tanim(f)
        _same_scene(jcomp.scene, tcomp.scene)
        _same_camera(jcomp.camera, tcomp.camera)


@pytest.mark.parametrize("trace", ["sweep", "march"])
def test_sponza_matches_jax(jbench, monkeypatch, tmp_path, trace):
    """``build_sponza_composer`` and ``_sponza_orbit`` on a stand-in asset
    (the flagship's meshes as a GLB at Sponza's path under
    ``REALISM_EFFECTS_REFERENCE``; the JAX bench's path pointed at it)."""
    path = tmp_path.joinpath(*bench.SPONZA_GLB)
    path.parent.mkdir(parents=True)
    write_glb(analytic.flagship_meshes(), str(path))
    monkeypatch.setenv("REALISM_EFFECTS_REFERENCE", str(tmp_path))
    monkeypatch.setattr(jbench, "SPONZA_GLB", str(path))
    monkeypatch.setattr(jbench, "WIDTH", 96)
    monkeypatch.setattr(jbench, "HEIGHT", 64)
    monkeypatch.setattr(jbench, "TRACE", trace)
    assert bench.sponza_path() == str(path)
    jcomp, jcam = jbench.build_sponza_composer()
    tcomp, tcam = bench.build_sponza_composer(96, 64, "cpu", trace)
    _same_composer(jcomp, tcomp)
    for f in (0, 7):
        jbench._sponza_orbit(jcam, f)
        bench._sponza_orbit(tcam, f)
        _same_camera(jcam, tcam)


# ---------------------------------------------------------------------
# small runs on the CPU
# ---------------------------------------------------------------------

def _records(capsys) -> list[dict]:
    lines = capsys.readouterr().out.strip().splitlines()
    return [json.loads(line) for line in lines]


def _check_headline(rec: dict, metric: str):
    assert set(rec) == {"metric", "value", "unit", "median_ms", "device"}
    assert rec["metric"] == metric and rec["unit"] == "ms/frame"
    assert rec["device"] == "cpu"
    assert math.isfinite(rec["value"]) and 0 < rec["value"] <= rec["median_ms"]


def _jax_name(jbench_src: str, name: str, height: int) -> str:
    """``name`` as the JAX bench spells it at 1080p, at ``height``."""
    assert name in jbench_src
    return name.replace("1080p", f"{height}p")


@pytest.fixture(scope="module")
def jbench_src():
    with open(os.path.join(ROOT, "bench.py")) as f:
        return f.read()


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(bench, "WIDTH", 96)
    monkeypatch.setattr(bench, "HEIGHT", 64)
    monkeypatch.setattr(bench, "ITERS", 2)
    monkeypatch.setattr(bench, "BATCHES", 2)
    monkeypatch.setattr(bench, "SYNCED", 2)


def test_breakdown_run_on_cpu(small, capsys, tmp_path, jbench_src):
    """``--breakdown --json``: the per-frame-synced record, one pass record
    a stage under the JAX bench's names with its bytes, the headline last;
    the artifact holds the same records and the meta."""
    out = tmp_path / "bench.json"
    assert bench.main(["--device", "cpu", "--breakdown", "--json", str(out)]) == 0
    recs = _records(capsys)
    assert all("vs_baseline" not in r for r in recs)
    synced, *passes, head = recs
    assert synced["metric"] == _jax_name(jbench_src, "frame_ms_1080p_per_frame_synced", 64)
    assert synced["value"] > 0 and synced["sync_floor_ms"] >= 0
    assert "pass_ms_1080p." in jbench_src
    assert [p["metric"] for p in passes] == [f"pass_ms_64p.{s}" for s in STAGES]
    for p in passes:
        assert math.isfinite(p["value"]) and p["value"] > 0
        assert p["gbytes"] > 0 and p["hbm_util"] == "not measured"
    _check_headline(head, _jax_name(
        jbench_src, "frame_ms_1080p_full_stack_ssgi_hbao_traa_mb", 64))
    art = json.loads(out.read_text())
    assert art["records"] == recs
    assert art["meta"]["trace"] == "sweep" and art["meta"]["device"] == "cpu"
    assert "card" not in art["meta"]


@pytest.mark.parametrize("argv", [[], ["--trace", "march"]])
def test_default_run_on_cpu(small, capsys, monkeypatch, argv, jbench_src):
    monkeypatch.setattr(bench, "WIDTH", 48)
    monkeypatch.setattr(bench, "HEIGHT", 32)
    assert bench.main(["--device", "cpu", *argv]) == 0
    recs = _records(capsys)
    assert len(recs) == 1
    _check_headline(recs[0], _jax_name(
        jbench_src, "frame_ms_1080p_full_stack_ssgi_hbao_traa_mb", 32))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_config_run_on_cpu(monkeypatch, capsys, n):
    monkeypatch.setattr(bench, "CONFIG_SIZES", {k: (32, 48) for k in range(1, 6)})
    monkeypatch.setattr(bench, "WARMUP", 1)
    monkeypatch.setattr(bench, "ITERS", 1)
    monkeypatch.setattr(bench, "BATCHES", 2)
    assert bench.main(["--device", "cpu", "--config", str(n)]) == 0
    recs = _records(capsys)
    assert len(recs) == 1
    _check_headline(recs[0], f"baseline_config_{n}_32p")


def test_sponza_breakdown_run_on_cpu(small, capsys, monkeypatch, tmp_path, jbench_src):
    path = tmp_path.joinpath(*bench.SPONZA_GLB)
    path.parent.mkdir(parents=True)
    write_glb(analytic.flagship_meshes(), str(path))
    monkeypatch.setenv("REALISM_EFFECTS_REFERENCE", str(tmp_path))
    assert bench.main(["--device", "cpu", "--scene", "sponza", "--breakdown"]) == 0
    *passes, head = _records(capsys)
    assert "pass_ms_sponza_1080p." in jbench_src
    assert [p["metric"] for p in passes] == [f"pass_ms_sponza_64p.{s}" for s in STAGES]
    assert all("gbytes" not in p for p in passes)
    _check_headline(head, _jax_name(
        jbench_src, "frame_ms_sponza_1080p_full_stack_ssgi_hbao_traa_mb", 64))


# ---------------------------------------------------------------------
# refusals, the byte counter, the import rule
# ---------------------------------------------------------------------

def test_sponza_without_the_asset_exits_naming_its_path(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("REALISM_EFFECTS_REFERENCE", str(tmp_path))
    with pytest.raises(SystemExit) as exc:
        bench.main(["--device", "cpu", "--scene", "sponza"])
    assert isinstance(exc.value.code, str)   # a message: exit status 1
    assert str(tmp_path.joinpath(*bench.SPONZA_GLB)) in exc.value.code
    assert capsys.readouterr().out == ""


def test_no_card_and_no_cpu_asked_for_raises(monkeypatch, capsys):
    """No fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--breakdown"], ["--config", "2"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bench.main(argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.build_composer(96, 64, None)
    assert capsys.readouterr().out == ""


def test_traffic_counts_each_tensor_once():
    """Reads of tensors from before the stage once each (a view by the
    elements it sees), in-place writes once, the created outputs once;
    intermediates and views are free; kernel inputs count through
    ``require_cuda``."""
    x, y, z = torch.ones(10, 10), torch.ones(10, 10), torch.ones(7)
    require = cuda_build.require_cuda
    with bench.Traffic(torch.device("cpu")) as traffic:
        a = x * 2 + x                   # x read twice: 400 bytes; a: 400
        b = y[:, :1] * 3                # a 10-element view of y: 40; b: 40
        y.add_(1.0)                     # y written in place: 400
        with pytest.raises(ValueError):
            cuda_build.require_cuda(z)  # a kernel's input: 28
    assert traffic.total((a, {"b": [b], "x": x})) == 400 + 400 + 40 + 40 + 400 + 28
    assert cuda_build.require_cuda is require


def test_bench_imports_no_jax():
    """Importing the port's bench loads no ``jax``, no JAX package and not
    the root ``bench.py`` (importable as ``bench`` from the checkout)."""
    code = ("import sys, realism_effects_tpu_torch.bench; "
            "print([m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'realism_effects_tpu', 'bench')])")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"
