"""The port's per-pixel SSGI march (``trace="march"``) vs the JAX
package, on the CPU.

- ``ops.ssgi.view_space_ray_march`` against the JAX package's
  ``_view_space_ray_march`` run op by op (``jax.lax.fori_loop`` replaced
  by a Python loop inside the test, so that XLA compiles each operation
  alone) on cosine-hemisphere rays about each pixel's normal, made from
  a seed with numpy, under a perspective and an orthographic camera over
  the analytic scene at 48 x 64: at most FLIP_FRAC = 0.1% of pixels flip
  their hit or differ by more than 1e-4 in uv or hit position (measured:
  none; the largest error 3.8e-6, an ulp of XLA's and ATen's ``exp``
  moving a step). XLA compiles the loop's body as one fusion when the
  loop runs as written, and that moves a bisection's side in 7 pixels of
  3072 against its own op-by-op run, so the op-by-op run is the
  reference.
- ``ops.ssgi.ssgi`` with the march against the JAX package's op by op
  (the loops as above), modes ``ssgi`` and ``ssr``, with and without
  ``missed_rays``, frames 0-2, the environment carried across by
  ``convert.env_from_numpy``: at most 0.1% of pixels off by more than
  1e-4. The march route draws no ``bin_noise``, builds no sweep table
  and does not prewarp.
- ``SSGIEffect(trace="march")`` through ``render_external`` over 3
  moving frames against the JAX composer (which runs the march jitted):
  the SSGI slice's bounds, max 2e-3, mean 1e-5, at most 1% of pixels
  off by more than 1e-4.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realism_effects_tpu as jre
from realism_effects_tpu.core.framebuffers import GBuffer as JG
from realism_effects_tpu.core.framebuffers import VelocityBuffer as JV
from realism_effects_tpu.ops import ssgi as jssgi
import realism_effects_tpu_torch as tre
from realism_effects_tpu_torch import analytic, convert
from realism_effects_tpu_torch.core import math3d
from realism_effects_tpu_torch.ops import ssgi as tssgi
from realism_effects_tpu_torch.ops.cuda_build import launches

H, W = 48, 64
N_FRAMES = 3
FLIP_FRAC = 1e-3
TOL, MEAN_TOL, PIX_TOL, PIX_FRAC = 2e-3, 1e-5, 1e-4, 1e-2
_GB = ("diffuse", "normal", "roughness", "metalness", "emissive", "depth")
_VEL = ("velocity", "normal", "depth")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cameras(kind):
    if kind == "ortho":
        make = lambda m: m.OrthographicCamera(-2.0 * W / H, 2.0 * W / H, 2.0, -2.0, 0.1, 100)
    else:
        make = lambda m: m.PerspectiveCamera(50, W / H, 0.1, 100)
    return make(tre), make(jre)


def _frame(first, kind="persp"):
    """Analytic buffers (plane, box, sphere) of orbit frame ``first`` and
    both packages' camera matrices."""
    tcam, jcam = _cameras(kind)
    gb, vel, color = analytic.frames_at(tcam, [first], H, W, "cpu", sphere=True)[0]
    analytic.orbit(jcam, first)
    return gb, vel, color, tcam.matrices(), jcam.matrices()


@pytest.fixture
def op_by_op(monkeypatch):
    """``jax.lax.fori_loop`` as a Python loop: the JAX march op by op."""
    def fori_loop(lower, upper, body, carry):
        for i in range(lower, upper):
            carry = body(jnp.int32(i), carry)
        return carry

    monkeypatch.setattr(jax.lax, "fori_loop", fori_loop)


@pytest.fixture(scope="module")
def jax_env():
    return jre.build_equirect_env(jre.procedural_sky(64, 128))


@pytest.mark.parametrize("kind", ["persp", "ortho"])
def test_view_space_ray_march_matches_jax(op_by_op, kind):
    gb, _, _, tcam, jcam = _frame(3, kind)
    view_pos = math3d.get_view_position(
        math3d.uv_grid(H, W), math3d.depth_to_view_z(gb.depth, tcam),
        tcam.projection_matrix, tcam.projection_matrix_inverse)
    n = math3d.normalize(math3d.transform_dir_transpose(
        tcam.camera_matrix_world, gb.normal)).numpy().astype(np.float64)
    r = np.random.default_rng(11)
    d = r.normal(size=(H, W, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ray = n + d  # cosine-distributed about the normal
    ray = (ray / np.maximum(np.linalg.norm(ray, axis=-1, keepdims=True), 1e-9)).astype(np.float32)
    rb = r.random((H, W)).astype(np.float32)
    cfg = dict(trace="march", steps=20, refine_steps=5)
    want = jssgi._view_space_ray_march(
        jnp.asarray(view_pos.numpy()), jnp.asarray(ray), jnp.asarray(gb.depth.numpy()),
        jcam, jnp.asarray(rb), 10.0, 10.0, jssgi.SSGIConfig(**cfg))
    launches.clear()
    got = tssgi.view_space_ray_march(
        view_pos, torch.from_numpy(ray), gb.depth, tcam, torch.from_numpy(rb), 10.0,
        10.0, tssgi.SSGIConfig(**cfg))
    assert not launches   # the CPU runs the plain route
    jmiss = np.asarray(want[2])
    assert 0.1 < (~jmiss).mean() < 1.0  # both hits and misses
    bad = jmiss != got[2].numpy()
    for g, w_ in zip(got[:2], want[:2]):
        bad |= np.abs(g.numpy() - np.asarray(w_)).max(-1) > 1e-4
    assert bad.mean() <= FLIP_FRAC
    assert (got[1].numpy()[got[2].numpy()] == 1.0e9).all()


@pytest.mark.parametrize("missed_rays", [False, True])
@pytest.mark.parametrize("mode", ["ssgi", "ssr"])
@pytest.mark.parametrize("frame", [0, 1, 2])
def test_ssgi_march_matches_jax(op_by_op, jax_env, monkeypatch, frame, mode,
                                missed_rays):
    gb, vel, color, tcam, jcam = _frame(frame)
    acc = np.random.default_rng(frame).uniform(0, 1.5, (H, W, 3)).astype(np.float32)
    kw = dict(trace="march", mode=mode, missed_rays=missed_rays)
    want = jssgi.ssgi(JG(**{f: jnp.asarray(getattr(gb, f).numpy()) for f in _GB}),
                      JV(**{f: jnp.asarray(getattr(vel, f).numpy()) for f in _VEL}),
                      jnp.asarray(acc), jnp.asarray(color.numpy()), jax_env, jcam,
                      frame, jssgi.SSGIConfig(**kw))

    def refuse(*a, **k):
        raise AssertionError("the march route reached a sweep-only step")

    for name in ("bilinear_window", "sweep_ray_march", "blue_noise_image"):
        if name == "blue_noise_image":
            real = tssgi.blue_noise_image
            monkeypatch.setattr(tssgi, name, lambda h, w, f, **kw: (
                refuse() if f >= 2048 else real(h, w, f, **kw)))
        else:
            monkeypatch.setattr(tssgi, name, refuse)
    calls = []
    march = tssgi.view_space_ray_march
    monkeypatch.setattr(tssgi, "view_space_ray_march",
                        lambda *a: calls.append(1) or march(*a))
    got = tssgi.ssgi(gb, vel, torch.from_numpy(acc), color,
                     convert.env_from_numpy(jax_env, "cpu"), tcam, frame,
                     tssgi.SSGIConfig(**kw))
    assert len(calls) == (2 if mode == "ssgi" else 1)
    for g, w_ in zip(got, want):
        assert g.shape == (H, W, 4) and bool(torch.isfinite(g).all())
        err = np.abs(g.numpy() - np.asarray(w_)).max(-1)
        assert (err > 1e-4).mean() <= FLIP_FRAC
    if mode == "ssgi":
        assert (got[0][..., 0] == -1.0).any() and (got[0][..., 0] > 0).any()
    else:
        assert (got[0][..., :3] == -1.0).any()
    assert (got[1][..., 3] > 0).any()  # hits carry a ray length


@pytest.fixture(scope="module")
def jax_run():
    """The JAX composer's images of ``SSGIEffect(trace="march")`` over 3
    orbit frames of the analytic buffers, and the buffers."""
    cam = tre.PerspectiveCamera(50, W / H, 0.1, 100)
    frames = analytic.frames_at(cam, range(N_FRAMES), H, W, "cpu", sphere=True)
    scene = jre.Scene()
    scene.environment = jre.build_equirect_env(jre.procedural_sky(64, 128))
    jcam = jre.PerspectiveCamera(50, W / H, 0.1, 100)
    comp = jre.EffectComposer(scene, jcam, W, H)
    comp.add_effect(jre.SSGIEffect(trace="march"))
    images = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i, (gb, vel, color) in enumerate(frames):
            analytic.orbit(jcam, i)
            images.append(np.asarray(comp.render_external(
                JG(**{f: jnp.asarray(getattr(gb, f).numpy()) for f in _GB}),
                JV(**{f: jnp.asarray(getattr(vel, f).numpy()) for f in _VEL}),
                jnp.asarray(color.numpy()), dt=1 / 60)))
    return frames, scene.environment, images


def test_march_effect_matches_jax_composer(jax_run, monkeypatch):
    frames, jenv, images = jax_run
    scene = tre.Scene()
    scene.environment = convert.env_from_numpy(jenv, "cpu")
    cam = tre.PerspectiveCamera(50, W / H, 0.1, 100)
    comp = tre.EffectComposer(scene, cam, W, H, device="cpu")
    effect = tre.SSGIEffect(trace="march")
    assert effect.cfg.trace == "march"
    comp.add_effect(effect)
    calls = []
    march = tssgi.view_space_ray_march
    monkeypatch.setattr(tssgi, "view_space_ray_march",
                        lambda *a: calls.append(1) or march(*a))
    got = analytic.run_frames(comp, cam, frames, range(N_FRAMES))
    assert len(calls) == 2 * N_FRAMES
    for g, want in zip(got, images):
        g = g.numpy()
        assert g.shape == (H, W, 3) and np.isfinite(g).all()
        err = np.abs(g - want)
        assert err.max() <= TOL
        assert err.mean() <= MEAN_TOL
        assert (err.max(-1) > PIX_TOL).mean() <= PIX_FRAC
