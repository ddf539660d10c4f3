"""SSGI Selection through the port's ``EffectComposer.render`` vs the JAX
package's, on the CPU: ``tests/test_golden.py``'s scene with the box
excluded (``Mesh.gi_exclude``), ``SSGIEffect(steps=8, refine_steps=2)``
with ``selection="mask"`` (the excluded pixels sent to background by the
G-buffer's ``mesh_id``) and ``"rerender"`` (a second raster pass without
the box's faces), 48 x 48 over two frames. Bounds as in
``tests/test_torch_render.py``: max 1e-1, mean 5e-4, at most 0.5% of
pixels off by more than 1e-2 (measured, both modes: max 4.1e-2 at one
pixel of 2304, mean 3.8e-5).
"""

import numpy as np
import pytest
import torch

import realism_effects_tpu as jre
import realism_effects_tpu_torch as tre
from realism_effects_tpu_torch import convert

from test_torch_render import _check, _jax_frames, _scene


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env():
    return jre.build_equirect_env(jre.procedural_sky(32, 64))


@pytest.mark.parametrize("selection", ["mask", "rerender"])
def test_selection_matches_jax(env, selection):
    size, n = 48, 2
    jscene, jcam = _scene(jre, env, exclude_box=True)
    jcomp = jre.EffectComposer(jscene, jcam, size, size)
    jcomp.add_effect(jre.SSGIEffect(steps=8, refine_steps=2, selection=selection))
    want = _jax_frames(jcomp, n)
    scene, cam = _scene(tre, convert.env_from_numpy(env, "cpu"), exclude_box=True)
    comp = tre.EffectComposer(scene, cam, size, size, device="cpu")
    comp.add_effect(tre.SSGIEffect(steps=8, refine_steps=2, selection=selection))
    got = [comp.render(dt=1 / 60).numpy() for _ in range(n)]
    for g, w in zip(got, want):
        _check(g, w)
    # the excluded box's pixels show the scene colour unchanged
    plain = tre.EffectComposer(*_scene(tre, convert.env_from_numpy(env, "cpu")),
                               size, size, device="cpu")
    plain.add_effect(tre.SSGIEffect(steps=8, refine_steps=2))
    assert not np.allclose(plain.render(dt=1 / 60).numpy(), got[0], atol=1e-3)
