"""The port's tools on the CPU: ``ops/copy.py``, the demo
(``tools/demo.py``) against the JAX package's ``examples/demo.py``, the
option sweep and the debug GUI (the cases of ``tests/test_debug_gui.py``).

The JAX demo is loaded by path and only builds its scenes and effects
here; nothing JAX-side is rendered. The scenes must pack the same arrays
and give the same camera matrices exactly (the same numpy code builds
them), but the product matrix, which the JAX package multiplies in
float32 on its device (1e-6, as in ``tests/test_torch_core.py``).
"""

import dataclasses
import importlib.util
import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

from realism_effects_tpu_torch.ops.copy import copy_textures, snapshot_to_host
from realism_effects_tpu_torch.scene.scene import _PACKED_DTYPES
from realism_effects_tpu_torch.tools import debug_gui, demo, option_sweep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = ["showcase", "traa_test", "ao", "lights", "gltf", "dynamic"]


@pytest.fixture(scope="module")
def jax_demo():
    spec = importlib.util.spec_from_file_location(
        "jax_examples_demo", os.path.join(ROOT, "examples", "demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------
# ops/copy.py
# ---------------------------------------------------------------------

def test_copy_textures_are_independent():
    a = [torch.ones(4, 3, 4), torch.zeros(4, 3)]
    b = copy_textures(a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    b[0].add_(1.0)
    assert float(a[0].max()) == 1.0 and float(b[0].min()) == 2.0


def test_snapshot_to_host_maps_every_tensor_leaf():
    @dataclasses.dataclass
    class Pair:
        a: torch.Tensor
        b: int

    tree = {"x": torch.arange(6.0).reshape(2, 3), "list": [torch.ones(2), "s"],
            "pair": Pair(torch.zeros(1), 3), "tup": (torch.tensor(2),)}
    out = snapshot_to_host(tree)
    assert isinstance(out["x"], np.ndarray)
    np.testing.assert_array_equal(out["x"], np.arange(6.0).reshape(2, 3))
    assert isinstance(out["list"][0], np.ndarray) and out["list"][1] == "s"
    assert isinstance(out["pair"], Pair) and isinstance(out["pair"].a, np.ndarray)
    assert out["pair"].b == 3
    assert isinstance(out["tup"], tuple) and int(out["tup"][0]) == 2


# ---------------------------------------------------------------------
# the demo against the JAX demo
# ---------------------------------------------------------------------

def _same_camera(jcam, tcam):
    jm, tm = jcam.matrices(), tcam.matrices()
    for f in ("projection_matrix", "projection_matrix_inverse", "view_matrix",
              "camera_matrix_world", "position"):
        np.testing.assert_array_equal(np.asarray(getattr(tm, f)),
                                      np.asarray(getattr(jm, f)), err_msg=f)
    # the JAX package multiplies these two in float32 on its device: the
    # bound of tests/test_torch_core.py::test_camera_matrices_equal
    np.testing.assert_allclose(tm.projection_view_matrix,
                               np.asarray(jm.projection_view_matrix),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", SCENES)
def test_demo_scene_matches_jax(jax_demo, name):
    """The port's ``build_scene`` packs the same arrays, model matrices,
    lights and camera as the JAX demo's; animated scenes stay equal a
    second into the animation."""
    jscene, jcam, janim = jax_demo.build_scene(name)
    tscene, tcam, tanim = demo.build_scene(name, "cpu")
    assert (janim is None) == (tanim is None)
    frames = (0,) if tanim is None else (0, 60)
    for f in frames:
        if tanim is not None:
            janim(f)
            tanim(f)
        want = jscene.pack()
        got = tscene.pack_arrays()
        for k in _PACKED_DTYPES:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(getattr(want, k)),
                                          err_msg=f"{name} {k}")
        np.testing.assert_array_equal(tscene.model_matrices(),
                                      np.asarray(jscene.model_matrices()))
        _same_camera(jcam, tcam)
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


@pytest.mark.parametrize("names,aa,trace", [
    (["ssgi", "ssr", "hbao", "gtao", "motion_blur", "sharpness", "sparkle",
      "lens_distortion", "gradual_background", "tonemap", "vignette", "bloom",
      "traa", "taa", "fxaa", "smaa"], "none", "march"),
    (["ssgi", "motion_blur"], "traa", "sweep"),
    (["hbao"], "fxaa", "march"), (["ssgi"], "msaa", "march"),
    (["ssr"], "smaa", "sweep"), (["gtao"], "taa", "march")])
def test_demo_effects_match_jax(jax_demo, names, aa, trace):
    want = [_options(e) for e in jax_demo.build_effects(names, aa, trace)]
    got = [_options(e) for e in demo.build_effects(names, aa, trace)]
    assert [w["class"] for w in want] == [g["class"] for g in got]
    for w, g in zip(want, got):
        assert set(w) <= set(g), w["class"]
        assert {k: g[k] for k in w} == w, w["class"]


@pytest.mark.parametrize("aa", ["traa", "none", "msaa"])
def test_demo_full_stack_matches_jax(jax_demo, aa, monkeypatch, tmp_path):
    """``full`` is the reference demo's stack and order. Its LUT is the
    reference project's ``lut_v2.3dl``: the port's path is pinned to a
    file under ``tmp_path`` and the JAX demo's is answered by a stub of
    ``os.path.exists``, so no real location is probed. Without the file
    both demos refuse alike; with a cube in its place both build the same
    classes and options."""
    import realism_effects_tpu as jre
    import realism_effects_tpu_torch as tre

    lut_path = str(tmp_path / "lut_v2.3dl")
    monkeypatch.setattr(demo, "LUT_3DL", lut_path)
    exists = os.path.exists

    def lut_exists(present):
        return lambda p: (present if str(p).endswith("lut_v2.3dl")
                          else exists(p))

    monkeypatch.setattr(os.path, "exists", lut_exists(False))
    with pytest.raises(SystemExit, match="lut"):
        jax_demo.build_effects(["full"], aa)
    with pytest.raises(SystemExit, match="lut"):
        demo.build_effects(["full"], aa)
    cube = np.stack(np.meshgrid(*[np.linspace(0, 1, 4)] * 3, indexing="ij"),
                    -1).astype(np.float32)
    monkeypatch.setattr(os.path, "exists", lut_exists(True))
    monkeypatch.setattr(jre, "load_lut_3dl", lambda path: cube)
    monkeypatch.setattr(tre, "load_lut_3dl",
                        lambda path: cube if path == lut_path else None)
    want = [_options(e) for e in jax_demo.build_effects(["full"], aa)]
    got = [_options(e) for e in demo.build_effects(["full"], aa)]
    assert [w["class"] for w in want] == [g["class"] for g in got]
    assert [g["class"] for g in got][-1] == "LUT3DEffect"
    for w, g in zip(want, got):
        assert {k: g[k] for k in w} == w, w["class"]


def test_demo_reference_assets_default_inside_the_checkout(monkeypatch):
    """Without ``REALISM_EFFECTS_REFERENCE`` the reference assets are
    looked for under ``reference/`` of this checkout, nowhere beside it;
    the variable names another directory."""
    import importlib

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.delenv("REALISM_EFFECTS_REFERENCE", raising=False)
    mod = importlib.reload(demo)
    try:
        assert mod.LUT_3DL == os.path.join(repo, "reference", "example",
                                           "public", "lut_v2.3dl")
        assert mod.SPONZA.startswith(os.path.join(repo, "reference") + os.sep)
        monkeypatch.setenv("REALISM_EFFECTS_REFERENCE", "/elsewhere")
        mod = importlib.reload(demo)
        assert mod.LUT_3DL.startswith("/elsewhere" + os.sep)
    finally:
        monkeypatch.delenv("REALISM_EFFECTS_REFERENCE", raising=False)
        importlib.reload(demo)


def test_demo_unknown_scene_and_missing_asset():
    with pytest.raises(SystemExit, match="unknown scene"):
        demo.build_scene("nope", "cpu")
    with pytest.raises(Exception):
        demo.build_scene("asset:/nonexistent/file.glb", "cpu")


def test_tools_need_cuda_unless_the_cpu_is_asked_for(tmp_path, monkeypatch):
    """No fallback: without a card the demo, the sweep and the GUI raise
    unless the CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        demo.main(["--scene", "lights", "--size", "16", "--frames", "1",
                   "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        option_sweep.sweep("hbao", "spp", [2], size=16, frames=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        debug_gui.GuiState("showcase", "hbao", 16, aa=False)
    assert not (tmp_path / "final.png").exists()


def test_demo_main_writes_final_png(tmp_path, capsys):
    res = demo.main(["--scene", "lights", "--size", "32", "--frames", "3",
                     "--device", "cpu", "--save-every", "2",
                     "--out", str(tmp_path)])
    assert (tmp_path / "final.png").read_bytes()[:4] == b"\x89PNG"
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "final.png", "frame_0000.png", "frame_0002.png"]
    img = res["image"]
    assert tuple(img.shape) == (32, 32, 3) and bool(torch.isfinite(img).all())
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert "steady median" in line and "fps" in line


def test_demo_msaa_and_sweep_trace(tmp_path):
    res = demo.main(["--scene", "dynamic", "--effects", "ssgi,motion_blur",
                     "--aa", "msaa", "--trace", "sweep", "--size", "32",
                     "--frames", "2", "--device", "cpu", "--out", str(tmp_path)])
    assert bool(torch.isfinite(res["image"]).all())
    assert (tmp_path / "final.png").exists()


# ---------------------------------------------------------------------
# the option sweep
# ---------------------------------------------------------------------

def test_option_sweep_and_contact_sheet(tmp_path):
    res = option_sweep.sweep("hbao", "spp", [2, 4], size=32, frames=2,
                             device="cpu")
    assert [v for v, _ in res] == [2, 4]
    assert all(img.shape == (32, 32, 3) and np.isfinite(img).all()
               for _, img in res)
    assert not np.array_equal(res[0][1], res[1][1])
    out = tmp_path / "sheet.png"
    sheet = option_sweep.contact_sheet(res, str(out))
    assert sheet.shape == (32, 65, 3) and out.read_bytes()[:4] == b"\x89PNG"
    assert [option_sweep._parse_value(v) for v in ("3", "0.5", "true", "x")] == [
        3, 0.5, True, "x"]


# ---------------------------------------------------------------------
# the debug GUI: the cases of tests/test_debug_gui.py
# ---------------------------------------------------------------------

def _state(effect="ssgi", size=48):
    return debug_gui.GuiState("showcase", effect, size, aa=False, device="cpu")


def test_gui_render_and_option_routing():
    st = _state()
    assert st.render_png()[:4] == b"\x89PNG"
    # uniform option: the same effect object changed, no rebuild
    eff_before = st.composer.effects[0]
    st.set_option("distance", 3.0)
    assert st.composer.effects[0] is eff_before
    assert st.composer.effects[0].distance == 3.0
    # static option: the effect rebuilt and the state reset
    st.set_option("steps", 4)
    assert st.composer.effects[0] is not eff_before
    assert st.composer._state is None
    assert st.render_png()[:4] == b"\x89PNG"


def test_gui_output_texture_inspector():
    st = _state()
    st.set_option("output_texture", "denoised_diffuse")
    assert st.render_png()[:4] == b"\x89PNG"


def test_gui_hbao_effect():
    st = _state(effect="hbao")
    st.set_option("spp", 2)
    st.set_option("power", 3.0)
    assert st.render_png()[:4] == b"\x89PNG"


def test_gui_config_kwargs_reconstruct():
    """The copy-config keywords rebuild an equivalent effect."""
    from realism_effects_tpu_torch import SSGIEffect

    st = _state()
    st.set_option("distance", 5.0)
    st.set_option("steps", 6)
    eff = SSGIEffect(**{k: v for k, v in st.kwargs.items() if v != ""})
    assert eff.distance == 5.0
    assert eff.cfg.steps == 6


def test_gui_server_endpoints():
    """The HTTP round trip: /, /state, /set (uniform and static),
    /advance, /config against a live server on a free local port."""
    from http.server import ThreadingHTTPServer

    state = debug_gui.GuiState("showcase", "hbao", 40, aa=False, device="cpu")
    server = ThreadingHTTPServer(("127.0.0.1", 0), debug_gui.make_handler(state))
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        def api(path, body=None):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{path}",
                data=json.dumps(body).encode() if body else None,
                method="POST" if body else "GET")
            return urllib.request.urlopen(req, timeout=300).read()

        assert b"realism_effects_tpu_torch" in api("/")
        s = json.loads(api("/state"))
        assert s["effect"] == "hbao" and s["png"]
        r = json.loads(api("/set", {"name": "power", "value": 3.0}))
        assert "power=3.0" in r["config"] and r["note"] == ""
        r = json.loads(api("/set", {"name": "spp", "value": 2}))
        assert "static option" in r["note"]
        assert json.loads(api("/advance", {"frames": 2}))["png"]
        assert json.loads(api("/config"))["kwargs"]["spp"] == 2
    finally:
        server.shutdown()
        server.server_close()
