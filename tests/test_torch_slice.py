"""The port's HBAO + TRAA slice end to end vs the JAX package, on the CPU.

The JAX ``EffectComposer.render_external`` runs ``HBAOEffect()`` +
``TRAAEffect()`` on G-buffers from the JAX rasterizer (the
``test_external_ingestion.py`` scene, camera moving over 3 frames); the
port's composer runs on the same buffers carried over by ``convert.py``.
Tolerance: max 1e-3, mean 1e-5. The first frame agrees to 1e-6. From
the second frame on, a handful of pixels (under 0.01%) sit on a discrete
decision that a float32 ulp flips -- a nearest-texel snap of an HBAO
sample or a Poisson tap, the Poisson weight cut-off at 1e-4 -- and move
by up to 6e-4 (measured: 4.4e-4 in HBAO alone, 2.9e-4 in TRAA alone, on
the third frame); the mean error stays under 1e-6.
"""

import os
import re
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

import realism_effects_tpu as jre
from realism_effects_tpu.scene.rasterizer import (rasterize_gbuffer,
                                                  rasterize_velocity)
from realism_effects_tpu.scene.shading import shade_direct
import realism_effects_tpu_torch as tre
from realism_effects_tpu_torch import convert
from realism_effects_tpu_torch.ops.cuda_build import launches

H, W = 64, 96
TOL = 1e-3
MEAN_TOL = 1e-5
EYES = [(3.0, 2.5, 4.0), (3.08, 2.5, 3.95), (3.15, 2.46, 3.9)]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _place(cam, eye):
    cam.set_position(*eye)
    cam.look_at((0, 0.5, 0))


@pytest.fixture(scope="module")
def jax_run():
    """Buffers of each frame, the JAX composer's images, and its state
    after frame 2 (with the counters the port needs to resume)."""
    scene = jre.Scene()
    scene.add(jre.make_plane(20, jre.Material(diffuse=(0.6, 0.6, 0.65, 1.0))))
    box = scene.add(jre.make_box((1, 1, 1),
                                 jre.Material(diffuse=(0.9, 0.3, 0.2, 1.0))))
    box.set_matrix(jre.translation(0, 0.5, 0))
    packed = scene.pack()
    mm = scene.model_matrices()
    cam = jre.PerspectiveCamera(50, W / H, 0.1, 100)
    comp = jre.EffectComposer(scene, cam, W, H)
    comp.add_effect(jre.HBAOEffect())
    comp.add_effect(jre.TRAAEffect())
    frames, images, carried = [], [], None
    prev_vp = None
    for i, eye in enumerate(EYES):
        _place(cam, eye)
        m = cam.matrices()
        vp = m.projection_view_matrix
        gb = rasterize_gbuffer(packed, mm, vp, H, W)
        vel = rasterize_velocity(packed, mm, mm, vp,
                                 vp if prev_vp is None else prev_vp, H, W)
        color = shade_direct(gb, m, scene.lighting_params())
        prev_vp = vp
        frames.append(jax.tree.map(np.asarray, (gb, vel, color)))
        images.append(np.asarray(comp.render_external(gb, vel, color, dt=1 / 60)))
        if i == 1:
            carried = dict(
                state=jax.tree.map(np.asarray, comp._state), frame=comp.frame,
                cnmf=comp.camera_not_moved_frames,
                prev_world=comp._prev_world, prev_proj=comp._prev_proj)
    return frames, images, carried


def _port_composer():
    cam = tre.PerspectiveCamera(50, W / H, 0.1, 100)
    comp = tre.EffectComposer(None, cam, W, H, device="cpu")
    comp.add_effect(tre.HBAOEffect())
    comp.add_effect(tre.TRAAEffect())
    return comp, cam


def _render(comp, cam, eye, frame):
    gb, vel, color = frame
    _place(cam, eye)
    return comp.render_external(convert.gbuffer_from_numpy(gb, "cpu"),
                                convert.velocity_from_numpy(vel, "cpu"),
                                torch.from_numpy(np.array(color)),
                                dt=1 / 60).numpy()


def test_slice_matches_jax_every_frame(jax_run):
    frames, images, _ = jax_run
    comp, cam = _port_composer()
    for eye, frame, want in zip(EYES, frames, images):
        got = _render(comp, cam, eye, frame)
        assert got.shape == (H, W, 3) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        assert np.abs(got - want).mean() < MEAN_TOL
    assert comp.frame == 3
    assert comp.state("traa")["history"].shape == (H, W, 4)


def test_state_carried_from_jax(jax_run):
    """Frame 3 from the JAX composer's state after frame 2 agrees."""
    frames, images, carried = jax_run
    comp, cam = _port_composer()
    comp.set_state(convert.state_from_numpy(carried["state"], "cpu"),
                   carried["frame"], carried["cnmf"], carried["prev_world"],
                   carried["prev_proj"])
    got = _render(comp, cam, EYES[2], frames[2])
    np.testing.assert_allclose(got, images[2], rtol=0, atol=TOL)
    assert np.abs(got - images[2]).mean() < MEAN_TOL


def test_save_and_load_state_round_trip(jax_run, tmp_path):
    frames = jax_run[0]
    a, cam_a = _port_composer()
    b, cam_b = _port_composer()
    _render(a, cam_a, EYES[0], frames[0])
    a.save_state(str(tmp_path / "state.npz"))
    b.load_state(str(tmp_path / "state.npz"))
    np.testing.assert_array_equal(_render(a, cam_a, EYES[1], frames[1]),
                                  _render(b, cam_b, EYES[1], frames[1]))


def test_cpu_run_never_launches_a_kernel(jax_run):
    comp, cam = _port_composer()
    launches.clear()
    _render(comp, cam, EYES[0], jax_run[0][0])
    assert not launches


def test_render_needs_the_raster_slice():
    """render() rasterizes the composer's Scene; a composer built for
    render_external without one refuses it."""
    comp, _ = _port_composer()
    with pytest.raises(ValueError, match="Scene"):
        comp.render()


def test_package_imports_without_jax():
    code = ("import sys, realism_effects_tpu_torch, realism_effects_tpu_torch.analytic; "
            "import realism_effects_tpu_torch.parallel.sharding, "
            "realism_effects_tpu_torch.parallel.halo, "
            "realism_effects_tpu_torch.ops.copy, "
            "realism_effects_tpu_torch.tools.demo, "
            "realism_effects_tpu_torch.tools.option_sweep, "
            "realism_effects_tpu_torch.tools.debug_gui; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'realism_effects_tpu' not in sys.modules; "
            "assert 'PIL' not in sys.modules, 'PIL imported'")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
    banned = re.compile(
        r"^\s*(import|from)\s+(jax|chex|realism_effects_tpu)(\.|\s|$)", re.M)
    pkg = os.path.join(ROOT, "realism_effects_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    assert not banned.search(f.read()), name


def test_composer_bookkeeping_on_cpu():
    """reset() blends nothing in (keepData = 0: TRAA returns its input),
    collect_timings names each stage, set_size drops the state."""
    from realism_effects_tpu_torch import analytic

    comp, cam = analytic.hbao_traa_composer(27, 48, "cpu")
    frames = analytic.frames_at(cam, range(3), 27, 48, "cpu")
    analytic.run_frames(comp, cam, frames[:2], range(2))
    comp.reset()
    comp.collect_timings = True
    out = analytic.run_frames(comp, cam, frames[2:], [2])[0]
    assert set(comp.last_timings) == {"hbao", "traa"}
    assert all(v >= 0.0 for v in comp.last_timings.values())
    assert float(comp.state("traa")["history"][..., 3].abs().max()) == 0.0
    ao_only = tre.EffectComposer(None, tre.PerspectiveCamera(50, 48 / 27, 0.1, 100),
                                 48, 27, device="cpu")
    ao_only.add_effect(tre.HBAOEffect())
    want = analytic.run_frames(ao_only, ao_only.camera, frames, range(3))[2]
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    comp.set_size(48, 24)
    assert comp.state("traa") is None and (comp.width, comp.height) == (48, 24)
