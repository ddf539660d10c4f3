"""The port's SSGI + HBAO + TRAA slice end to end vs the JAX package, on
the CPU.

The JAX ``EffectComposer.render_external`` runs ``SSGIEffect()`` +
``HBAOEffect()`` + ``TRAAEffect()`` under ``scene.environment =
build_equirect_env(procedural_sky(64, 128))`` on the analytic buffers of
``analytic.py`` (plane, box and the flagship's metallic sphere, camera
orbiting over 3 frames); the port's composer runs on the same buffers
with the environment carried over by ``convert.env_from_numpy``. The JAX
composer runs once for the module (its first frame compiles the whole
chain).

Tolerance: max 2e-3, mean 1e-5, at most 1% of pixels off by more than
1e-4. The first frame agrees to 2e-6. From the second frame on, the
trace reads last frame's output, and a decision that a float32 ulp moves
-- an atan2 that puts a ray in the next direction bin, a hit test, a
nearest-texel snap of an HBAO or Poisson tap, the Poisson weight cut-off
-- changes a pixel's sample (measured at 48 x 64: max 4.1e-4, mean
2.9e-7, 3 pixels of 3072 (0.1%) off by more than 1e-4 on the third
frame; from the carried state max 1.6e-4, mean 1.5e-7).
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
import realism_effects_tpu_torch as tre
from realism_effects_tpu_torch import analytic, convert
from realism_effects_tpu_torch.ops.cuda_build import launches

H, W = 48, 64
N_FRAMES = 3
TOL = 2e-3
MEAN_TOL = 1e-5
PIX_TOL = 1e-4
PIX_FRAC = 1e-2
_GB = ("diffuse", "normal", "roughness", "metalness", "emissive", "depth")
_VEL = ("velocity", "normal", "depth")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU runs here are a few thousand small ops a frame; with
    the test workers sharing the cores, torch's thread pool waits on
    descheduled threads at every op, so run them on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames():
    cam = tre.PerspectiveCamera(50, W / H, 0.1, 100)
    return analytic.frames_at(cam, range(N_FRAMES), H, W, "cpu", sphere=True)


@pytest.fixture(scope="module")
def jax_run():
    """Buffers of each frame, the JAX environment, the JAX composer's
    images, and its state after frame 2 with the counters the port needs
    to resume."""
    frames = _frames()
    scene = jre.Scene()
    scene.environment = jre.build_equirect_env(jre.procedural_sky(64, 128))
    cam = jre.PerspectiveCamera(50, W / H, 0.1, 100)
    comp = jre.EffectComposer(scene, cam, W, H)
    comp.add_effect(jre.SSGIEffect())
    comp.add_effect(jre.HBAOEffect())
    comp.add_effect(jre.TRAAEffect())
    images, carried = [], None
    # tracing the chain under pytest's recording warning filter takes
    # twice as long; the run raises no warning
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i, (gb, vel, color) in enumerate(frames):
            analytic.orbit(cam, i)
            out = comp.render_external(
                JG(**{f: jnp.asarray(getattr(gb, f).numpy()) for f in _GB}),
                JV(**{f: jnp.asarray(getattr(vel, f).numpy()) for f in _VEL}),
                jnp.asarray(color.numpy()), dt=1 / 60)
            images.append(np.asarray(out))
            if i == 1:
                carried = dict(
                    state=jax.tree.map(np.asarray, comp._state),
                    frame=comp.frame, cnmf=comp.camera_not_moved_frames,
                    prev_world=comp._prev_world, prev_proj=comp._prev_proj)
    return frames, scene.environment, images, carried


def _port_composer(env):
    cam = tre.PerspectiveCamera(50, W / H, 0.1, 100)
    scene = tre.Scene()
    scene.environment = env
    comp = tre.EffectComposer(scene, cam, W, H, device="cpu")
    comp.add_effect(tre.SSGIEffect())
    comp.add_effect(tre.HBAOEffect())
    comp.add_effect(tre.TRAAEffect())
    return comp, cam


def _check(got, want):
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    err = np.abs(got - want)
    assert err.max() <= TOL
    assert err.mean() <= MEAN_TOL
    assert (err.max(-1) > PIX_TOL).mean() <= PIX_FRAC


def test_slice_matches_jax_every_frame(jax_run):
    frames, jenv, images, _ = jax_run
    comp, cam = _port_composer(convert.env_from_numpy(jenv, "cpu"))
    got = analytic.run_frames(comp, cam, frames, range(N_FRAMES))
    for g, want in zip(got, images):
        _check(g.numpy(), want)
    np.testing.assert_allclose(got[0].numpy(), images[0], rtol=0, atol=2e-6)
    assert comp.frame == N_FRAMES
    hist = comp.state("ssgi")["history"]
    assert isinstance(hist, list) and [t.shape for t in hist] == [(H, W, 4)] * 2


def test_state_carried_from_jax(jax_run):
    """Frame 3 from the JAX composer's state after frame 2 agrees."""
    frames, jenv, images, carried = jax_run
    comp, cam = _port_composer(convert.env_from_numpy(jenv, "cpu"))
    comp.set_state(convert.state_from_numpy(carried["state"], "cpu"),
                   carried["frame"], carried["cnmf"], carried["prev_world"],
                   carried["prev_proj"])
    assert isinstance(comp.state("ssgi")["history"], list)
    got = analytic.run_frames(comp, cam, frames[2:], [2])[0]
    _check(got.numpy(), images[2])


def test_save_and_load_state_round_trip(jax_run, tmp_path):
    frames, jenv, _, _ = jax_run
    env = convert.env_from_numpy(jenv, "cpu")
    a, cam_a = _port_composer(env)
    b, cam_b = _port_composer(env)
    analytic.run_frames(a, cam_a, frames[:1], [0])
    a.save_state(str(tmp_path / "state.npz"))
    b.load_state(str(tmp_path / "state.npz"))
    for x, y in zip(a.state("ssgi")["history"], b.state("ssgi")["history"]):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(
        analytic.run_frames(a, cam_a, frames[1:2], [1])[0].numpy(),
        analytic.run_frames(b, cam_b, frames[1:2], [1])[0].numpy())


def test_cpu_run_never_launches_a_kernel(jax_run):
    frames, jenv, _, _ = jax_run
    comp, cam = _port_composer(convert.env_from_numpy(jenv, "cpu"))
    launches.clear()
    analytic.run_frames(comp, cam, frames[:1], [0])
    assert not launches


def test_convert_round_trips_list_state():
    rng = np.random.default_rng(0)
    state = {
        "__global__": {"last_velocity": {f: rng.random((4, 5) + s).astype(np.float32)
                                         for f, s in zip(_VEL, ((2,), (3,), ()))}},
        "ssgi": {"history": [rng.random((4, 5, 4)).astype(np.float32)
                             for _ in range(2)],
                 "composed": rng.random((4, 5, 3)).astype(np.float32)},
        "empty": {},
    }
    tstate = convert.state_from_numpy(state, "cpu")
    assert isinstance(tstate["ssgi"]["history"], list)
    assert isinstance(tstate["__global__"]["last_velocity"], tre.VelocityBuffer)
    flat = convert.flatten_state(convert.state_to_numpy(tstate))
    assert "ssgi/history/#1" in flat and "empty/" in flat
    back = convert.unflatten_state(flat)
    assert back["empty"] == {} and isinstance(back["ssgi"]["history"], list)
    for a, b in zip(back["ssgi"]["history"], state["ssgi"]["history"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(back["ssgi"]["composed"], state["ssgi"]["composed"])
    for f in _VEL:
        np.testing.assert_array_equal(back["__global__"]["last_velocity"][f],
                                      state["__global__"]["last_velocity"][f])


def test_environment_resolution():
    """A raw map is built once and rebuilt (with a history reset) only
    when its identity changes or on refresh_environment(); a prebuilt
    EquirectEnv is used as it is; (6, S, S, 3) cube faces become a
    (2S, 4S) equirect; any other shape raises."""
    h, w = 12, 16
    cam = tre.PerspectiveCamera(50, w / h, 0.1, 100)
    frames = analytic.frames_at(cam, range(2), h, w, "cpu", sphere=True)
    sky = tre.procedural_sky(16, 32)
    holder = tre.Scene()
    holder.environment = sky
    comp = tre.EffectComposer(holder, cam, w, h, device="cpu")
    comp.add_effect(tre.SSGIEffect())
    analytic.run_frames(comp, cam, frames[:1], [0])
    built = comp._resolve_environment()
    assert isinstance(built, tre.EquirectEnv) and built.size == (16, 32)
    assert comp._resolve_environment() is built
    comp._reset_pending = False
    holder.environment = sky.copy()
    assert comp._resolve_environment() is not built and comp._reset_pending
    comp.refresh_environment()
    rebuilt = comp._resolve_environment()
    assert rebuilt is not built
    holder.environment = tre.build_equirect_env(sky, device="cpu")
    assert comp._resolve_environment() is holder.environment
    holder.environment = np.ones((6, 8, 8, 3), np.float32)
    cube = comp._resolve_environment()
    assert cube.size == (16, 32) and comp._reset_pending
    np.testing.assert_allclose(cube.map.float().numpy(), 1.0)
    holder.environment = np.zeros((5, 8, 8, 3), np.float32)
    with pytest.raises(ValueError, match="cube"):
        comp._resolve_environment()


def test_effect_options_on_cpu():
    """Debug routing, the low preset (half-resolution trace), the
    per-pixel march and the selection modes."""
    h, w = 16, 24
    cam = tre.PerspectiveCamera(50, w / h, 0.1, 100)
    frames = analytic.frames_at(cam, range(2), h, w, "cpu", sphere=True)
    env = tre.build_equirect_env(tre.procedural_sky(16, 32), device="cpu")
    outs = {}
    for key, kw in [("full", {}), ("diffuse", dict(output_texture="diffuse")),
                    ("low", dict(preset="low")),
                    ("temporal", dict(denoise_mode="temporal")),
                    ("march", dict(trace="march"))]:
        scene = tre.Scene()
        scene.environment = env
        comp = tre.EffectComposer(scene, cam, w, h, device="cpu")
        comp.add_effect(tre.SSGIEffect(**kw))
        outs[key] = analytic.run_frames(comp, cam, frames, range(2))[-1]
    for key, img in outs.items():
        assert img.shape == (h, w, 3) and bool(torch.isfinite(img).all()), key
    assert not torch.equal(outs["full"], outs["diffuse"])
    assert not torch.equal(outs["full"], outs["low"])
    assert not torch.equal(outs["full"], outs["march"])
    assert tre.SSGIEffect(selection="rerender").selection == "rerender"
    with pytest.raises(ValueError, match="selection"):
        tre.SSGIEffect(selection="layers")
    assert tre.SSGIEffect(trace="march").cfg.trace == "march"
    with pytest.raises(ValueError, match="trace"):
        tre.SSGIEffect(trace="binned")
