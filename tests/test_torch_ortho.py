"""The port under an ``OrthographicCamera`` vs the JAX package, on the
CPU: the three cases of the JAX package's ``tests/test_ortho.py``.

- ``depth_to_view_z`` dispatches on ``P[3, 2]``: both projections agree
  with the JAX package's to 1e-6 relative (measured: equal).
- A wall at z = 0 seen from z = 7: the port's raster covers the frame
  and reads view z -7 at the centre, with the JAX package's depth to
  2e-5, the raster's bound under a perspective camera (its hoisted plane
  interpolants; measured 2.1e-7).
- The full stack, ``SSGIEffect(steps=6, refine_steps=2)`` +
  ``HBAOEffect(spp=4)`` + ``TRAAEffect()``, through ``render()`` at
  72 x 72 over 3 frames against the JAX ``render()``: the bounds of
  ``tests/test_torch_render.py`` (max 1e-1, mean 5e-4, at most 0.5% of
  pixels off by more than 1e-2; measured max 6.6e-2, mean 1.6e-4, at
  most 0.1% of pixels), and HBAO at 16 samples on the frame's raster
  against the JAX op at HBAO's tolerance, 2e-4 (measured 3.0e-7); its
  contact shadow reaches below 0.9.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realism_effects_tpu as jre
from realism_effects_tpu.core import math3d as jm
from realism_effects_tpu.ops import ao as jao
from realism_effects_tpu.scene.rasterizer import rasterize_gbuffer as jraster
import realism_effects_tpu_torch as tre
from realism_effects_tpu_torch import convert
from realism_effects_tpu_torch.core import math3d
from realism_effects_tpu_torch.ops import ao

SIZE = 72
N_FRAMES = 3
MAX_TOL, MEAN_TOL, PIX_TOL, PIX_FRAC = 1e-1, 5e-4, 1e-2, 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_depth_to_view_z_dispatch():
    depth = np.linspace(0.05, 0.95, 16).astype(np.float32)
    for make in (lambda m: m.PerspectiveCamera(50, 1, 0.1, 100),
                 lambda m: m.OrthographicCamera(-2, 2, 2, -2, 0.1, 100)):
        got = math3d.depth_to_view_z(torch.from_numpy(depth), make(tre).matrices())
        want = jm.depth_to_view_z(jnp.asarray(depth), make(jre).matrices())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    ortho = tre.OrthographicCamera(-2, 2, 2, -2, 0.1, 100)
    assert not ortho.is_perspective_camera and tre.PerspectiveCamera.is_perspective_camera
    np.testing.assert_allclose(ortho.projection_matrix,
                               jre.OrthographicCamera(-2, 2, 2, -2, 0.1, 100).projection_matrix)


def test_ortho_depth_maps_to_distance():
    """A wall at z = 0 seen by an ortho camera at z = 7: view z is -7."""
    packs = []
    for m in (tre, jre):
        scene = m.Scene()
        wall = scene.add(m.make_plane(8, m.Material()))
        wall.set_matrix(m.rotation_x(np.pi / 2))
        cam = m.OrthographicCamera(-2, 2, 2, -2, 0.1, 50)
        cam.set_position(0, 0, 7)
        cam.look_at((0, 0, 0))
        packs.append((scene, cam.matrices()))
    (scene, mats), (jscene, jmats) = packs
    gb = tre.rasterize_gbuffer(scene.pack("cpu"), torch.as_tensor(scene.model_matrices()),
                               mats.projection_view_matrix, 32, 32)
    depth = gb.depth.numpy()
    assert (depth < 1.0).mean() > 0.9
    view_z = math3d.depth_to_view_z(gb.depth, mats).numpy()
    assert abs(view_z[16, 16] - (-7.0)) < 1e-2
    want = jraster(jscene.pack(), jscene.model_matrices(), jmats.projection_view_matrix, 32, 32)
    np.testing.assert_allclose(depth, np.asarray(want.depth), rtol=0, atol=2e-5)


def _scene(m, env):
    scene = m.Scene()
    scene.environment = env
    scene.add(m.make_plane(12, m.Material(diffuse=(0.6, 0.6, 0.65, 1.0))))
    box = scene.add(m.make_box((1, 1, 1), m.Material(diffuse=(0.9, 0.3, 0.2, 1.0))))
    box.set_matrix(m.translation(0, 0.5, 0))
    cam = m.OrthographicCamera(-3, 3, 3, -3, 0.1, 50)
    cam.set_position(4, 3, 5)
    cam.look_at((0, 0.5, 0))
    comp = m.EffectComposer(scene, cam, SIZE, SIZE,
                            **({"device": "cpu"} if m is tre else {}))
    comp.add_effect(m.SSGIEffect(steps=6, refine_steps=2))
    comp.add_effect(m.HBAOEffect(spp=4))
    comp.add_effect(m.TRAAEffect())
    return scene, cam, comp


def test_full_stack_renders_with_ortho_camera():
    jenv = jre.build_equirect_env(jre.procedural_sky(32, 64))
    jscene, jcam, jcomp = _scene(jre, jenv)
    scene, cam, comp = _scene(tre, convert.env_from_numpy(jenv, "cpu"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = [np.asarray(jcomp.render(dt=1 / 60)) for _ in range(N_FRAMES)]
    got = [comp.render(dt=1 / 60).numpy() for _ in range(N_FRAMES)]
    for g, w_ in zip(got, want):
        assert g.shape == (SIZE, SIZE, 3) and np.isfinite(g).all()
        err = np.abs(g - w_)
        assert err.max() <= MAX_TOL
        assert err.mean() <= MEAN_TOL
        assert (err.max(-1) > PIX_TOL).mean() <= PIX_FRAC
    assert got[-1].max() > 0.01

    # AO darkens the floor-box contact region
    m = cam.matrices()
    gb = tre.rasterize_gbuffer(scene.pack("cpu"), torch.as_tensor(scene.model_matrices()),
                               m.projection_view_matrix, SIZE, SIZE)
    got_ao = ao.hbao(gb.depth, gb.normal, m, 0, ao.AOConfig(spp=16))[1].numpy()
    jm_ = jcam.matrices()
    jgb = jraster(jscene.pack(), jscene.model_matrices(), jm_.projection_view_matrix, SIZE, SIZE)
    want_ao = np.asarray(jao.hbao(jnp.asarray(gb.depth.numpy()), jnp.asarray(gb.normal.numpy()),
                                  jm_, jnp.int32(0), jao.AOConfig(spp=16))[1])
    assert np.isfinite(got_ao).all() and got_ao.min() < 0.9
    np.testing.assert_allclose(got_ao, want_ao, rtol=0, atol=2e-4)
