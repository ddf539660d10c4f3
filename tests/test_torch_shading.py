"""The port's direct-light shader vs the JAX package's, on the CPU, on the
same G-buffer (from the JAX rasterizer, with a baked-AO plane added) and
the same environment (carried over by ``convert.env_from_numpy``).

Tolerance 2e-5 absolute and relative: transcendental ulps (the point
lights' pow, the environment's atan2/acos; measured 6.9e-7). With the GGX specular sun and
point lights, rtol 1e-3: at a highlight of the roughness-0.2 sphere the
lobe's denominator 1 - NoH^2 (1 - a^4) (a^4 = 2.6e-6) is a difference of
numbers near 1, which magnifies an ulp of NoH (measured 1.8e-4 relative,
15 of 18432 values above 2e-5).
"""

import jax
import numpy as np
import pytest
import torch

import realism_effects_tpu as jre
from realism_effects_tpu.core.framebuffers import GBuffer as JG
from realism_effects_tpu.scene import rasterizer as jr
from realism_effects_tpu.scene import shading as jsh
import realism_effects_tpu_torch as tre
from realism_effects_tpu_torch import convert
from realism_effects_tpu_torch.scene import shading as tsh

H, W = 64, 96
_GB = ("diffuse", "normal", "roughness", "metalness", "emissive", "depth", "mesh_id",
       "ao")


@pytest.fixture(scope="module")
def inputs():
    scene = jre.Scene()
    scene.add(jre.make_plane(20, jre.Material(diffuse=(0.6, 0.6, 0.65, 1.0))))
    box = scene.add(jre.make_box((1, 1, 1), jre.Material(
        diffuse=(0.9, 0.3, 0.2, 1.0), emissive=(0.2, 0.1, 0.0))))
    box.set_matrix(jre.translation(0, 0.5, 0))
    sph = scene.add(jre.make_sphere(0.6, material=jre.Material(
        diffuse=(0.2, 0.5, 0.9, 1.0), roughness=0.2, metalness=0.8)))
    sph.set_matrix(jre.translation(1.5, 0.6, 0.5))
    cam = jre.PerspectiveCamera(50, W / H, 0.1, 100)
    cam.set_position(3.0, 2.5, 4.0)
    cam.look_at((0, 0.5, 0))
    m = cam.matrices()
    gb = jr.rasterize_gbuffer(scene.pack(), scene.model_matrices(),
                              m.projection_view_matrix, H, W)
    ao = np.random.default_rng(2).uniform(0.3, 1.0, (H, W)).astype(np.float32)
    gb = jax.tree.map(np.asarray, gb).replace(ao=ao)
    env = jre.build_equirect_env(jre.procedural_sky(32, 64))
    tcam = tre.PerspectiveCamera(50, W / H, 0.1, 100)
    tcam.set_position(3.0, 2.5, 4.0)
    tcam.look_at((0, 0.5, 0))
    return gb, m, tcam.matrices(), env


@pytest.mark.parametrize("case", ["flat", "env_fast", "env_exact", "lights",
                                  "lights_env"])
def test_shade_direct_matches_jax(inputs, case, monkeypatch):
    gb, jm, tm, jenv = inputs
    jscene, tscene = jre.Scene(background_color=(0.1, 0.2, 0.3)), \
        tre.Scene(background_color=(0.1, 0.2, 0.3))
    if case.startswith("lights"):
        for s in (jscene, tscene):
            s.sun_specular = 1.0
            s.add_point_light((1.0, 2.0, 1.0), color=(1, 0.8, 0.6), intensity=4.0,
                              distance=6.0)
            s.add_point_light((-1.5, 1.0, 2.0), intensity=2.0, decay=1.0)
    with_env = "env" in case
    fast = case != "env_exact"
    monkeypatch.setattr(jsh, "FAST_BACKGROUND", fast)
    monkeypatch.setattr(tsh, "FAST_BACKGROUND", fast)
    want = np.asarray(jsh.shade_direct(
        JG(**{f: getattr(gb, f) for f in _GB}), jm, jscene.lighting_params(),
        jenv if with_env else None))
    got = tsh.shade_direct(convert.gbuffer_from_numpy(gb, "cpu"), tm,
                           tscene.lighting_params("cpu"),
                           convert.env_from_numpy(jenv, "cpu") if with_env else None)
    assert got.shape == (H, W, 3) and got.dtype == torch.float32
    rtol = 1e-3 if case.startswith("lights") else 2e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=2e-5)
    bg = gb.depth >= 1.0
    assert bg.any() and (~bg).any()


def test_upsample2_matches_jax():
    c = np.random.default_rng(1).normal(size=(7, 9, 3)).astype(np.float32)
    for axis, n in ((0, 13), (1, 16)):
        want = np.asarray(jsh._upsample2(jax.numpy.asarray(c), n, axis))
        got = tsh._upsample2(torch.from_numpy(c), n, axis).numpy()
        np.testing.assert_array_equal(got, want)
