"""``EffectComposer(msaa=2, alpha_peels=...)`` of the port vs the JAX
package's, on the CPU.

The scene: a ground plane, a box at material alpha 0.5 and a cutout
quad whose alpha map is a checker of 0 and 1 in its green channel, so
the raster takes the alpha route with its depth peels (the scene has a
texture page) and its dither, at 2 x 2 the frame's size. ``TRAAEffect``
then reads the resolved planes: the centre sample of each 2 x 2 block of
depth and velocity, and the box average of the colour. Four frames at
48 x 64: three with the camera still (cnmf 0, 1, 2: the hard cut, then
the soft law) and one a step away (cnmf 0 again). The JAX composer runs
once for the module.

Tolerance: every frame within max 5e-3, mean 1e-5 (measured: max
6.6e-4, mean 1.4e-6, on the last frame). The resolve averages four
samples, whose shading rounds in XLA's fused order on the JAX side, and
TRAA's history carries those ulps into its clamp and blend.
"""

import warnings

import numpy as np
import pytest
import torch

import realism_effects_tpu as jre
import realism_effects_tpu_torch as tre
from realism_effects_tpu_torch.ops.cuda_build import launches

H, W = 48, 64
EYES = [(3.0, 2.5, 4.0)] * 3 + [(3.1, 2.5, 3.9)]
MAX_TOL, MEAN_TOL = 5e-3, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(m):
    scene = m.Scene()
    scene.add(m.make_plane(20, m.Material(diffuse=(0.6, 0.6, 0.65, 1.0))))
    box = scene.add(m.make_box((1, 1, 1), m.Material(diffuse=(0.9, 0.3, 0.2, 0.5))))
    box.set_matrix(m.translation(0, 0.5, 0))
    tex = np.ones((16, 16, 4), np.float32)
    yy, xx = np.mgrid[0:16, 0:16]
    tex[..., 1] = ((xx // 4 + yy // 4) % 2).astype(np.float32)
    quad = scene.add(m.make_plane(1.5, m.Material(diffuse=(0.3, 0.8, 0.3, 1.0),
                                                  alpha_map=tex)))
    quad.set_matrix(m.translation(0.8, 0.9, 0.6) @ m.rotation_x(1.2))
    return scene


def _run(m, **kw):
    cam = m.PerspectiveCamera(50, W / H, 0.1, 100)
    comp = m.EffectComposer(_scene(m), cam, W, H, msaa=2, alpha_peels=3, **kw)
    comp.add_effect(m.TRAAEffect())
    images = []
    for eye in EYES:
        cam.set_position(*eye)
        cam.look_at((0, 0.5, 0))
        images.append(np.asarray(comp.render(dt=1 / 60)))
    return images, comp


@pytest.fixture(scope="module")
def jax_images():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return _run(jre)[0]


def test_render_msaa_alpha_matches_jax(jax_images):
    launches.clear()
    images, comp = _run(tre, device="cpu")
    assert not launches    # the CPU runs plain
    for i, (got, want) in enumerate(zip(images, jax_images)):
        assert got.shape == (H, W, 3) and np.isfinite(got).all()
        d = np.abs(got - want)
        assert d.max() <= MAX_TOL and d.mean() <= MEAN_TOL, (i, d.max(), d.mean())
    vel = comp.state("__global__")["last_velocity"]
    assert tuple(vel.depth.shape) == (H, W) and vel.depth.is_contiguous()


def test_msaa_resolves_edges_and_alpha_peels_reach_the_raster(tmp_path):
    """msaa=2 changes silhouette pixels of the msaa=1 frame (the box
    average), the composer's ``alpha_peels`` reaches the raster (5 peels
    resolve the floor under four stacked cutouts where 3 leave
    background, ``tests/test_alpha_map.py::TestAlphaPeelDepth``), and
    ``profile`` writes a Chrome trace of its frames."""
    def stacked():
        tex = np.ones((32, 32, 4), np.float32)
        tex[8:24, 8:24, 1] = 0.0
        scene = tre.Scene()
        scene.add(tre.make_plane(4, tre.Material(diffuse=(0.2, 0.8, 0.2, 1.0))))
        for i in range(4):
            p = scene.add(tre.make_plane(4, tre.Material(
                diffuse=(0.7, 0.7, 0.7, 1.0), alpha_map=tex)))
            p.set_matrix(tre.translation(0, 1.0 + 0.2 * i, 0))
        cam = tre.PerspectiveCamera(50, 1, 0.1, 100)
        cam.set_position(0, 5, 0.01)
        cam.look_at((0, 0, 0))
        return scene, cam

    hole = {}
    for peels in (3, 5):
        scene, cam = stacked()
        comp = tre.EffectComposer(scene, cam, 48, 48, device="cpu", alpha_peels=peels)
        hole[peels] = comp.render(dt=1 / 60)[21:27, 21:27, 1].mean()
    assert float(hole[5]) > float(hole[3]) + 0.02
    frames = {}
    for ss in (1, 2):
        cam = tre.PerspectiveCamera(50, W / H, 0.1, 100)
        cam.set_position(*EYES[0])
        cam.look_at((0, 0.5, 0))
        comp = tre.EffectComposer(_scene(tre), cam, W, H, device="cpu", msaa=ss)
        frames[ss] = comp.render(dt=1 / 60).numpy()
    changed = np.abs(frames[1] - frames[2]).max(-1) > 0.01
    assert 20 < changed.sum() < 0.5 * H * W
    path = comp.profile(str(tmp_path / "trace"), frames=2)
    assert comp.frame == 3 and path.endswith(".json")
    with open(path) as f:
        assert "stage:raster" in f.read()
