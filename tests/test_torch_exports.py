"""The reference's three other effect exports -- ``SSREffect``,
``GTAOEffect`` and ``TAAPass`` -- in one port composer vs the JAX
package's, on the CPU.

Both ``EffectComposer.render_external`` runs take the analytic buffers
of ``analytic.py`` (plane, box and the flagship's metallic sphere) under
``build_equirect_env(procedural_sky(64, 128))``, the environment carried
over by ``convert.env_from_numpy``, over 4 frames: the camera still for
2, one orbit step, still again (``analytic.still_then_step``), so TAA
accumulates, starts again and accumulates. The JAX composer runs once
for the module (its first frame compiles the whole chain).

Tolerance: the SSGI slice's (``tests/test_torch_ssgi_slice.py``), mean
1e-5 and at most 1% of pixels off by more than 1e-4, with its max of
2e-3 on all but at most 0.1% of the pixels and 5e-3 on those. From the
second frame on the trace reads last frame's output, and a decision that
a float32 ulp moves (an SSR ray's direction bin or hit, a Poisson tap's
nearest texel) changes a pixel's sample. GTAO adds one such decision a
sample: where a sample lands on a texel boundary its nearest depth
fetch depends on the last ulp of its position. The port's ``gtao``
agrees with the JAX package's run op by op to 1.5e-6 on these frames,
but the JAX composer runs it jitted, and XLA's fused arithmetic moves a
few samples to the next texel: the JAX package's own jitted and
op-by-op ``gtao`` differ by up to 2.2e-2 on the AO plane of frame 1 (2
pixels above 2e-4). After the Poisson pass and the compose the port
measured max 3.6e-3, 4 pixels of 15360 above 2e-3, mean 2.1e-6.
"""

import dataclasses
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

H, W = 96, 160
STEPS = analytic.still_then_step(0, 4, 2)   # [0, 0, 1, 1]
TOL = 2e-3
TOL_FRAC = 1e-3    # the pixels a GTAO sample's texel moves
FLIP_TOL = 5e-3    # measured 3.6e-3
MEAN_TOL = 1e-5
PIX_TOL = 1e-4
PIX_FRAC = 1e-2
_GB = ("diffuse", "normal", "roughness", "metalness", "emissive", "depth")
_VEL = ("velocity", "normal", "depth")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stack(m, comp):
    comp.add_effect(m.SSREffect())
    comp.add_effect(m.GTAOEffect())
    comp.add_effect(m.TAAPass())
    return comp


@pytest.fixture(scope="module")
def jax_run():
    """Buffers of each frame, the JAX environment, the JAX composer's
    images, and its state after the camera's step (frame 2) with the
    counters the port needs to resume."""
    cam = tre.PerspectiveCamera(50, W / H, 0.1, 100)
    frames = analytic.frames_at(cam, STEPS, H, W, "cpu", sphere=True)
    scene = jre.Scene()
    scene.environment = jre.build_equirect_env(jre.procedural_sky(64, 128))
    jcam = jre.PerspectiveCamera(50, W / H, 0.1, 100)
    comp = _stack(jre, jre.EffectComposer(scene, jcam, W, H))
    images, carried = [], None
    # tracing the chain under pytest's recording warning filter takes
    # twice as long; the run raises no warning
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i, (gb, vel, color) in enumerate(frames):
            analytic.orbit(jcam, STEPS[i])
            out = comp.render_external(
                JG(**{f: jnp.asarray(getattr(gb, f).numpy()) for f in _GB}),
                JV(**{f: jnp.asarray(getattr(vel, f).numpy()) for f in _VEL}),
                jnp.asarray(color.numpy()), dt=1 / 60)
            images.append(np.asarray(out))
            if i == 2:
                carried = dict(
                    state=jax.tree.map(np.asarray, comp._state),
                    frame=comp.frame, cnmf=comp.camera_not_moved_frames,
                    prev_world=comp._prev_world, prev_proj=comp._prev_proj)
    return frames, scene.environment, images, carried


def _port_composer(env):
    cam = tre.PerspectiveCamera(50, W / H, 0.1, 100)
    scene = tre.Scene()
    scene.environment = env
    return _stack(tre, tre.EffectComposer(scene, cam, W, H, device="cpu")), cam


def _check(got, want):
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    err = np.abs(got - want)
    assert (err.max(-1) > TOL).mean() <= TOL_FRAC
    assert err.max() <= FLIP_TOL
    assert err.mean() <= MEAN_TOL
    assert (err.max(-1) > PIX_TOL).mean() <= PIX_FRAC


def test_exports_match_jax_every_frame(jax_run):
    frames, jenv, images, _ = jax_run
    comp, cam = _port_composer(convert.env_from_numpy(jenv, "cpu"))
    got = [g.numpy() for g in analytic.run_frames(comp, cam, frames, STEPS)]
    for g, want in zip(got, images):
        _check(g, want)
    # TAA: still frames blend, the step restarts the average
    assert comp.camera_not_moved_frames == 1 and comp.frame == 4
    hist = comp.state("ssr")["history"]
    assert isinstance(hist, list) and [t.shape for t in hist] == [(H, W, 4)]
    assert comp.state("taa")["accumulated"].shape == (H, W, 3)
    np.testing.assert_array_equal(comp.state("taa")["accumulated"].numpy(), got[-1])


def test_state_carried_from_jax(jax_run):
    """Frame 3 from the JAX composer's state after the camera's step
    agrees: SSR's one-texture history and composed output, TAA's
    accumulation."""
    frames, jenv, images, carried = jax_run
    assert set(carried["state"]["ssr"]) == {"history", "composed"}
    assert len(carried["state"]["ssr"]["history"]) == 1
    comp, cam = _port_composer(convert.env_from_numpy(jenv, "cpu"))
    comp.set_state(convert.state_from_numpy(carried["state"], "cpu"),
                   carried["frame"], carried["cnmf"], carried["prev_world"],
                   carried["prev_proj"])
    got = analytic.run_frames(comp, cam, frames[3:], STEPS[3:])[0]
    _check(got.numpy(), images[3])


def test_save_and_load_state_round_trip(jax_run, tmp_path):
    frames, jenv, _, _ = jax_run
    env = convert.env_from_numpy(jenv, "cpu")
    a, cam_a = _port_composer(env)
    b, cam_b = _port_composer(env)
    analytic.run_frames(a, cam_a, frames[:2], STEPS[:2])
    a.save_state(str(tmp_path / "state.npz"))
    b.load_state(str(tmp_path / "state.npz"))
    hist_a, hist_b = a.state("ssr")["history"], b.state("ssr")["history"]
    assert isinstance(hist_b, list) and len(hist_b) == 1
    assert torch.equal(hist_a[0], hist_b[0])
    assert torch.equal(a.state("taa")["accumulated"], b.state("taa")["accumulated"])
    assert b.camera_not_moved_frames == a.camera_not_moved_frames == 1
    np.testing.assert_array_equal(
        analytic.run_frames(a, cam_a, frames[2:3], STEPS[2:3])[0].numpy(),
        analytic.run_frames(b, cam_b, frames[2:3], STEPS[2:3])[0].numpy())


def test_cpu_run_never_launches_a_kernel(jax_run):
    frames, jenv, _, _ = jax_run
    comp, cam = _port_composer(convert.env_from_numpy(jenv, "cpu"))
    launches.clear()
    analytic.run_frames(comp, cam, frames[:1], STEPS[:1])
    assert not launches


def _fields(cfg):
    """The routing fields of a temporal or denoise config."""
    keep = {"texture_count", "reproject_specular", "neighborhood_clamp",
            "input_type", "is_specular", "confidence_power", "log_transform",
            "iterations", "radius"}
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name in keep}


def test_exports_and_configuration():
    """The three names are exported, with the JAX package's defaults and
    routing: SSR traces, reprojects and denoises one specular texture (by
    the sweep or the march); GTAO takes 16 samples; TAA asks for the
    jittered camera. The port exports every name of the JAX package's,
    the glTF and animation loaders included."""
    for name in ("SSREffect", "GTAOEffect", "TAAPass"):
        assert name in tre.__all__ and getattr(tre, name) is not None
    ssr, jssr = tre.SSREffect(), jre.SSREffect()
    assert (ssr.name, ssr.mode) == (jssr.name, jssr.mode) == ("ssr", "ssr")
    for cfg in ("temporal_cfg", "denoise_cfg"):
        assert _fields(getattr(ssr, cfg)) == _fields(getattr(jssr, cfg))
    assert tre.SSGIEffect().temporal_cfg.texture_count == 2
    gtao, jgtao = tre.GTAOEffect(), jre.GTAOEffect()
    assert (gtao.name, gtao.kind, gtao.cfg.spp) == (jgtao.name, jgtao.kind, jgtao.cfg.spp)
    assert tre.TAAPass.needs_jitter and tre.TAAPass.name == jre.TAAPass.name == "taa"
    ssr_march = tre.SSREffect(trace="march")
    assert (ssr_march.cfg.trace, ssr_march.cfg.mode) == ("march", "ssr")
    # every export of the JAX package, and no other
    assert set(tre.__all__) == set(jre.__all__)
    assert all(getattr(tre, name) is not None for name in tre.__all__)
    assert tre.SSGI_PRESETS == jre.SSGI_PRESETS
