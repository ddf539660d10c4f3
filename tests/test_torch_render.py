"""The port's ``EffectComposer.render`` (raster + shade + SSGI + HBAO +
motion blur + TRAA) vs the JAX package's, on the CPU.

The scene, camera and stack are ``tests/test_golden.py``'s (96 x 96, six
frames at dt = 1/60), the environment carried over by
``convert.env_from_numpy``. The JAX composer runs once for the module.

- Against the JAX ``render()``, every frame: max 1e-1, mean 5e-4, at most
  0.5% of pixels off by more than 1e-2. The port's visibility hoists the
  interpolants per triangle where the JAX package's CPU scan sums them
  per pixel (depth 2e-5 apart), and XLA's fused plane evaluations round
  in another order; the SSGI trace turns such ulps into another hit or
  bin for a few rays, a different GI sample that the denoiser and TRAA
  spread (measured: max 1.1e-2, mean 1.3e-4, 1 pixel of 9216 off by more
  than 1e-2, on the second frame). The max bounds one such pixel: its new
  sample may come from another surface or the sky (SSGI alone measured
  4.6e-2).
- Against ``tests/fixtures/golden_full_stack.npz``: RMSE under 2e-2, the
  golden test's own bound (measured 3.3e-3; the JAX frame's is 3.3e-3).

Most of the mean error is HBAO's: at depth-buffer values near 0.98 the
view z moves by about 230 times the depth's 1e-5, which shifts the
horizon angles (HBAO alone: mean 1.4e-4).
"""

import os
import warnings

import numpy as np
import pytest
import torch

import realism_effects_tpu as jre
import realism_effects_tpu_torch as tre
from realism_effects_tpu_torch import convert
from realism_effects_tpu_torch.ops.cuda_build import launches

SIZE = 96
N_FRAMES = 6
MAX_TOL, MEAN_TOL = 1e-1, 5e-4
PIX_TOL, PIX_FRAC = 1e-2, 5e-3
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden_full_stack.npz")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(m, env, exclude_box=False):
    """``tests/test_golden.py``'s scene and camera."""
    scene = m.Scene()
    scene.environment = env
    scene.add(m.make_plane(20, m.Material(diffuse=(0.6, 0.6, 0.65, 1.0))))
    box = scene.add(m.make_box((1, 1, 1), m.Material(diffuse=(0.9, 0.3, 0.2, 1.0))))
    box.set_matrix(m.translation(0, 0.5, 0))
    box.gi_exclude = exclude_box
    ball = scene.add(m.make_sphere(0.5, material=m.Material(
        diffuse=(0.2, 0.5, 0.9, 1.0), roughness=0.2, metalness=0.8)))
    ball.set_matrix(m.translation(1.3, 0.5, 0.6))
    cam = m.PerspectiveCamera(50, 1, 0.1, 100)
    cam.set_position(3, 2.5, 4)
    cam.look_at((0, 0.5, 0))
    return scene, cam


def _golden_stack(m, comp):
    comp.add_effect(m.SSGIEffect(steps=8, refine_steps=2))
    comp.add_effect(m.HBAOEffect(spp=4))
    comp.add_effect(m.MotionBlurEffect(samples=8))
    comp.add_effect(m.TRAAEffect())
    return comp


def _jax_frames(comp, n):
    # tracing the chain under pytest's recording warning filter takes
    # twice as long; the run raises no warning
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return [np.asarray(comp.render(dt=1 / 60)) for _ in range(n)]


@pytest.fixture(scope="module")
def jax_run():
    env = jre.build_equirect_env(jre.procedural_sky(32, 64))
    scene, cam = _scene(jre, env)
    comp = _golden_stack(jre, jre.EffectComposer(scene, cam, SIZE, SIZE))
    return env, _jax_frames(comp, N_FRAMES)


def _check(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want)
    assert err.max() <= MAX_TOL, err.max()
    assert err.mean() <= MEAN_TOL, err.mean()
    assert (err.max(-1) > PIX_TOL).mean() <= PIX_FRAC


def test_render_matches_jax_and_golden(jax_run):
    env, want = jax_run
    scene, cam = _scene(tre, convert.env_from_numpy(env, "cpu"))
    comp = _golden_stack(tre, tre.EffectComposer(scene, cam, SIZE, SIZE, device="cpu"))
    launches.clear()
    got = [comp.render(dt=1 / 60).numpy() for _ in range(N_FRAMES)]
    for g, w in zip(got, want):
        _check(g, w)
    golden = np.load(FIXTURE)["image"].astype(np.float32)
    assert float(np.sqrt(np.square(got[-1] - golden).mean())) < 2e-2
    assert comp.frame == N_FRAMES and comp.delta_time == 1 / 60
    # the CPU run takes the kernels' plain versions
    assert not launches


def test_render_options_on_cpu():
    """share_visibility and collect_timings; an alpha scene and msaa > 1
    render (``tests/test_torch_msaa.py`` holds them to the JAX package):
    the msaa = 2 frame keeps the frame's size and moves the box's
    silhouette."""
    env = tre.build_equirect_env(tre.procedural_sky(16, 32), device="cpu")
    scene, cam = _scene(tre, env)
    comp = tre.EffectComposer(scene, cam, 32, 32, device="cpu")
    comp.add_effect(tre.HBAOEffect(spp=2))
    comp.add_effect(tre.TRAAEffect())
    comp.collect_timings = True
    a = comp.render(dt=1 / 60)
    assert set(comp.last_timings) == {"raster", "hbao", "traa"}
    comp.share_visibility = True
    b = comp.render(dt=1 / 60)
    assert a.shape == b.shape == (32, 32, 3) and bool(torch.isfinite(b).all())

    scene.meshes[1].material.diffuse = (0.9, 0.3, 0.2, 0.5)
    glass = tre.EffectComposer(scene, cam, 32, 32, device="cpu")
    glass.add_effect(tre.TRAAEffect())
    assert bool(torch.isfinite(glass.render()).all())
    one = tre.EffectComposer(scene, cam, 32, 32, device="cpu").render(dt=1 / 60)
    two = tre.EffectComposer(scene, cam, 32, 32, device="cpu", msaa=2).render(dt=1 / 60)
    assert two.shape == (32, 32, 3) and bool(torch.isfinite(two).all())
    assert int(((one - two).abs().amax(-1) > 0.01).sum()) > 4
