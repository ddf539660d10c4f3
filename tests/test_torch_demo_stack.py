"""The port's ``render()`` of the reference demo's full stack vs the JAX
package's, on the CPU.

``analytic.demo_stack_composer``'s stack, in its order: SSGI (sweep) ->
tone mapping -> TRAA -> sharpness -> vignette -> bloom -> the code-built
grading LUT (``analytic.demo_lut``), on the flagship scene at 54 x 96
over 3 frames of the orbit; the JAX composer runs the same stack on the
same scene (the environment carried over by ``convert.env_from_numpy``)
once for the module.

Bounds, derived as ``tests/test_torch_render.py`` derives its own: the
raster and SSGI differ from the JAX package's by float32 ulps that move
a few rays to another hit or direction bin, and the denoiser and TRAA
spread such a pixel's new GI sample to its neighbours. Tone mapping
compresses those errors into [0, 1]; sharpness (x 1 + s) and bloom
spread them again. So: max 1e-1, mean 5e-4, at most 0.5% of pixels off
by more than 1e-2 (measured: max 7.8e-4, mean 1.3e-5, no pixel off by
more than 1e-3, on the third frame).
"""

import warnings

import numpy as np
import pytest
import torch

import realism_effects_tpu as jre
from realism_effects_tpu_torch import analytic, convert
from realism_effects_tpu_torch.ops.cuda_build import launches

H, W = 54, 96
N_FRAMES = 3
MAX_TOL, MEAN_TOL = 1e-1, 5e-4
PIX_TOL, PIX_FRAC = 1e-2, 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_run():
    env = jre.build_equirect_env(jre.procedural_sky(64, 128))
    scene = jre.Scene()
    scene.environment = env
    scene.add(jre.make_plane(20, jre.Material(diffuse=(0.6, 0.6, 0.65, 1.0))))
    box = scene.add(jre.make_box((1, 1, 1), jre.Material(diffuse=(0.9, 0.3, 0.2, 1.0))))
    box.set_matrix(jre.translation(0, 0.5, 0))
    (cx, cy, cz), rad, albedo, rough, metal = analytic.SPHERE
    sph = scene.add(jre.make_sphere(rad, material=jre.Material(
        diffuse=albedo + (1.0,), roughness=rough, metalness=metal)))
    sph.set_matrix(jre.translation(cx, cy, cz))
    cam = jre.PerspectiveCamera(50, W / H, 0.1, 100)
    comp = jre.EffectComposer(scene, cam, W, H)
    for effect in (jre.SSGIEffect(), jre.ToneMappingEffect(), jre.TRAAEffect(),
                   jre.SharpnessEffect(), jre.VignetteEffect(), jre.BloomEffect(),
                   jre.LUT3DEffect(analytic.demo_lut())):
        comp.add_effect(effect)
    images = []
    # tracing under pytest's recording warning filter is slower; the run
    # raises no warning
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for f in range(N_FRAMES):
            analytic.orbit(cam, f)
            images.append(np.asarray(comp.render(dt=1 / 60)))
    return env, images


def test_demo_stack_matches_jax(jax_run):
    env, want = jax_run
    comp, cam = analytic.demo_stack_composer(H, W, "cpu")
    comp.scene.environment = convert.env_from_numpy(env, "cpu")
    assert [e.name for e in comp.effects] == [
        "ssgi", "tonemapping", "traa", "sharpness", "vignette", "bloom", "lut"]
    launches.clear()
    got = [g.numpy() for g in analytic.render_frames(comp, cam, range(N_FRAMES))]
    assert not launches    # plain versions on the CPU
    for g, w in zip(got, want):
        assert g.shape == w.shape == (H, W, 3) and np.isfinite(g).all()
        err = np.abs(g - w)
        assert err.max() <= MAX_TOL, err.max()
        assert err.mean() <= MEAN_TOL, err.mean()
        assert (err.max(-1) > PIX_TOL).mean() <= PIX_FRAC
    assert 0.0 <= got[-1].min() and got[-1].max() <= 1.0 and got[-1].std() > 0.05


def test_demo_lut_grades():
    lut = analytic.demo_lut()
    assert lut.shape == (32, 32, 32, 3) and lut.dtype == np.float32
    assert 0.0 <= lut.min() and lut.max() <= 1.0
    x = np.linspace(0, 1, 32)
    r, g, b = np.meshgrid(x, x, x, indexing="ij")
    ident = np.stack([r, g, b], -1)
    assert np.abs(lut - ident).max() > 0.05             # not the identity
    assert (np.diff(lut[:, 5, 5, 0]) > 0).all()         # monotone in red
