"""The port's cube maps, GGX prefilter and ``blur_env``, and the
composer's cube-map route, vs the JAX package, on the CPU.

Tolerance: the largest error over the largest value of the JAX result,
1e-5 (an ulp of atan2 or acos in a uv moves a bilinear fraction;
measured at most 8.2e-7 (``equirect_to_cube``), 3.7e-7
(``cube_to_equirect``), 2.5e-7 (``blur_env``), 2.1e-7 (the GGX levels),
2.0e-7 (``sample_bilinear_mip``)). The GGX sample table is host float64
in both packages and is equal. ``load_cubemap`` reads the same PNG
faces as the JAX function (PIL is imported inside it). The composer
turns (6, S, S, 3) faces into the (2S, 4S, 3) equirect that the JAX
composer builds, and the environment built from it equals the JAX
composer's array by array (the float16 rounding absorbs the ulps).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import realism_effects_tpu as jre
from realism_effects_tpu.core import envmap as jenv
from realism_effects_tpu.core import sampling as jsamp
import realism_effects_tpu_torch as tre
from realism_effects_tpu_torch.core import envmap, sampling

REL_TOL = 1e-5


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_equirect_to_cube_matches_jax():
    sky = envmap.procedural_sky(16, 32)
    got = envmap.equirect_to_cube(torch.from_numpy(sky), 8)
    assert got.shape == (6, 8, 8, 3) and got.device.type == "cpu"
    assert _rel(got, jenv.equirect_to_cube(sky, 8)) <= REL_TOL


@pytest.mark.parametrize("size,height,width", [(8, 16, 32), (6, 9, 20)])
def test_cube_to_equirect_matches_jax(size, height, width):
    faces = np.random.default_rng(size).uniform(0, 2, (6, size, size, 3)).astype(np.float32)
    got = envmap.cube_to_equirect(torch.from_numpy(faces), height, width)
    assert _rel(got, jenv.cube_to_equirect(jnp.asarray(faces), height, width)) <= REL_TOL


def test_direction_pdf_matches_jax():
    d = np.random.default_rng(1).normal(size=(9, 11, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[0, 0] = (0.0, 1.0, 0.0)  # the pole: pdf 0
    got = envmap.equirect_direction_pdf(torch.from_numpy(d))
    assert _rel(got, jenv.equirect_direction_pdf(jnp.asarray(d))) <= REL_TOL


@pytest.mark.parametrize("lod", ["scalar", "map"])
def test_sample_bilinear_mip_matches_jax(lod):
    r = np.random.default_rng(2)
    tex = r.random((20, 36, 3)).astype(np.float32)
    uv = r.uniform(-0.1, 1.1, (9, 11, 2)).astype(np.float32)
    lv = 2.3 if lod == "scalar" else r.uniform(-1, 6, (9, 11)).astype(np.float32)
    got = sampling.sample_bilinear_mip(sampling.build_mip_chain(torch.from_numpy(tex)),
                                       torch.from_numpy(uv), torch.as_tensor(lv))
    want = jsamp.sample_bilinear_mip(jsamp.build_mip_chain(jnp.asarray(tex)),
                                     jnp.asarray(uv), jnp.asarray(lv))
    assert _rel(got, want) <= REL_TOL


def test_ggx_prefilter_mips_matches_jax():
    sky = envmap.procedural_sky(16, 32)
    np.testing.assert_array_equal(envmap._ggx_sample_table(0.5, 96, 16, 32),
                                  jenv._ggx_sample_table(0.5, 96, 16, 32))
    got = envmap.ggx_prefilter_mips(torch.from_numpy(sky))
    want = jenv.ggx_prefilter_mips(jnp.asarray(sky))
    assert len(got) == len(want) == 5
    for g, w_ in zip(got, want):
        assert _rel(g, w_) <= REL_TOL


@pytest.mark.parametrize("blur", [0.0, 0.5])
def test_blur_env_matches_jax(blur):
    sky = torch.from_numpy(envmap.procedural_sky(16, 32))
    got = envmap.blur_env(sky, blur)
    if blur == 0.0:
        assert got is sky
        return
    assert _rel(got, jenv.blur_env(jnp.asarray(sky.numpy()), blur)) <= REL_TOL


def _write_faces(path, faces):
    """(6, S, S, 3) linear faces as sRGB PNGs, in file row order."""
    for name, face in zip(envmap.CUBE_FACE_NAMES, faces):
        srgb = np.where(face <= 0.0031308, face * 12.92,
                        1.055 * np.clip(face, 0, 1) ** (1 / 2.4) - 0.055)
        Image.fromarray((np.clip(srgb, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(str(path), f"{name}.png"))


def test_load_cubemap_matches_jax(tmp_path):
    """A PNG cube directory written from a smooth panorama loads to the
    JAX package's equirect, and back near the panorama itself (8-bit
    faces: median error under 0.02 in the band away from the poles)."""
    h, w = 32, 64
    v, u = np.meshgrid(np.linspace(0, 1, h, endpoint=False),
                       np.linspace(0, 1, w, endpoint=False), indexing="ij")
    eq = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * u), 0.5 + 0.4 * np.cos(np.pi * v),
                   0.5 + 0.3 * np.sin(2 * np.pi * (u + v))], -1).astype(np.float32)
    _write_faces(tmp_path, envmap.equirect_to_cube(torch.from_numpy(eq), 32).numpy())
    got = envmap.load_cubemap(str(tmp_path), height=h, device="cpu")
    assert got.shape == (h, 2 * h, 3)
    assert _rel(got, jenv.load_cubemap(str(tmp_path), height=h)) <= REL_TOL
    band = slice(h // 4, 3 * h // 4)
    assert float(np.median(np.abs(got.numpy()[band] - eq[band]))) < 0.02
    # the default height: the face size rounded up to a power of two
    assert envmap.load_cubemap(str(tmp_path), device="cpu").shape == (32, 64, 3)


def test_load_cubemap_missing_face_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="posx"):
        envmap.load_cubemap(str(tmp_path), device="cpu")


def _env_arrays(env):
    arrs = {f"mip{i}": m for i, m in enumerate(env.mips)}
    arrs.update(atlas=env.atlas.data, marginal=env.marginal,
                conditional=env.conditional, total_sum=env.total_sum,
                cdf_packed=env.cdf_packed)
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in arrs.items()}


@pytest.mark.parametrize("kind", ["array", "tensor"])
def test_composer_cube_route_matches_jax(kind):
    """(6, 16, 16, 3) faces as ``scene.environment`` (a numpy array or a
    tensor) build the environment of the JAX composer's cube route."""
    faces = envmap.equirect_to_cube(torch.from_numpy(envmap.procedural_sky(32, 64)), 16)
    jscene = jre.Scene()
    jscene.environment = faces.numpy()
    jcomp = jre.EffectComposer(jscene, jre.PerspectiveCamera(50, 1.0, 0.1, 100), 8, 8)
    want = jcomp._resolve_environment()
    scene = tre.Scene()
    scene.environment = faces.numpy() if kind == "array" else faces
    comp = tre.EffectComposer(scene, tre.PerspectiveCamera(50, 1.0, 0.1, 100), 8, 8,
                              device="cpu")
    got = comp._resolve_environment()
    assert got.size == want.size == (32, 64)
    assert got.atlas.shapes == want.atlas.shapes
    g_arrs, w_arrs = _env_arrays(got), _env_arrays(want)
    for k, v in w_arrs.items():
        assert g_arrs[k].dtype == v.dtype, k
        np.testing.assert_array_equal(g_arrs[k], v, err_msg=k)
    assert comp._resolve_environment() is got  # built once per map
