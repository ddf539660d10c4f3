"""Stochastic alpha in the port's rasterizer vs the JAX package, on the CPU.

The scenes: the flagship's plane, box and sphere with the box at
material alpha 0.5 and the sphere at 0.3 (``material``: one pass, no
texture pages); a plane under an alpha map whose green channel is 0.1 on
its left half and 0.9 on its right, seen from above (``alpha_map``,
``tests/test_alpha_map.py``'s ``TestAlphaLaw``); and four cutout planes
stacked over an opaque floor, each with a hole of alpha 0
(``cutouts``, the fixture of ``tests/test_alpha_map.py:92-160``), at 3
peels, where the hole falls to background, and at 5, where the floor
resolves. Each at cnmf 0 (the hard cut), 3 and 20 (the soft law), with
the dither of blue-noise index 11.

The JAX rasterizers are compiled (``jax.jit``), and so is the scan body
of their visibility even when it runs op by op. XLA's CPU backend
contracts the law's ``cnmf * 0.1 + 1`` and ``a + (a_step - a) * ramp``
into fused multiply-adds there (checked against numpy: the fused form
agrees on every input, the unfused one on about half); run op by op, the
JAX package's per-pixel winner test after the scan would round each
operation on its own. The port computes the fused form
(``raster_kernel.soft_alpha``), in the scan and in the winner test.

Tolerances: the raster's (``tests/test_torch_raster.py``). The port's
z-scan hoists the interpolants per triangle where the JAX scan sums them
per pixel, so a winner can flip where two surfaces tie within an ulp of
z, and with peels a flip carries into the next pass's exclusion: at most
``FLIP_FRAC`` of pixels may have another winner id (measured: 0 flips in
every case here, G-buffer and velocity), and where both pick the same
winner the material planes are exact, depth within 5e-5, normals 1e-3,
velocity 5e-5 and its depth 1e-4 (measured: 1.0e-5 and 7.5e-5 on the
material-alpha sphere; velocity 4.8e-7 and its depth 2.4e-7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realism_effects_tpu as jre
from realism_effects_tpu.core.rng import blue_noise_image as jnoise
from realism_effects_tpu.scene import rasterizer as jr
import realism_effects_tpu_torch as tre
from realism_effects_tpu_torch.core.rng import blue_noise_image as tnoise
from realism_effects_tpu_torch.scene import rasterizer as tr

H, W = 64, 96
FLIP_FRAC = 1e-3
NOISE_INDEX = 11


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _material(m):
    scene = m.Scene()
    scene.add(m.make_plane(20, m.Material(diffuse=(0.6, 0.6, 0.65, 1.0))))
    box = scene.add(m.make_box((1, 1, 1), m.Material(diffuse=(0.9, 0.3, 0.2, 0.5))))
    box.set_matrix(m.translation(0, 0.5, 0))
    sph = scene.add(m.make_sphere(0.6, 24, 16, material=m.Material(
        diffuse=(0.2, 0.5, 0.9, 0.3), roughness=0.2, metalness=0.8)))
    sph.set_matrix(m.translation(1.5, 0.6, 0.5))
    return scene, (3.0, 2.5, 4.0), (0, 0.5, 0)


def _alpha_map(m):
    tex = np.ones((64, 64, 4), np.float32)
    tex[:, :32, 1] = 0.1
    tex[:, 32:, 1] = 0.9
    scene = m.Scene()
    scene.add(m.make_plane(4, m.Material(diffuse=(0.7, 0.7, 0.7, 1.0), alpha_map=tex)))
    return scene, (0, 4, 0.01), (0, 0, 0)


def _cutouts(m):
    tex = np.ones((32, 32, 4), np.float32)
    tex[8:24, 8:24, 1] = 0.0          # alpha 0: always discarded
    scene = m.Scene()
    scene.add(m.make_plane(4, m.Material(diffuse=(0.2, 0.8, 0.2, 1.0))))
    for i in range(4):
        p = scene.add(m.make_plane(4, m.Material(diffuse=(0.7, 0.7, 0.7, 1.0),
                                                 alpha_map=tex)))
        p.set_matrix(m.translation(0, 1.0 + 0.2 * i, 0))
    return scene, (0, 5, 0.01), (0, 0, 0)


SCENES = {"material": _material, "alpha_map": _alpha_map, "cutouts": _cutouts}


def _view_proj(eye, target, jitter=None):
    cam = jre.PerspectiveCamera(50, W / H, 0.1, 100)
    cam.set_position(*eye)
    cam.look_at(target)
    if jitter is not None:
        cam.jitter(W, H, jitter)
    return np.asarray(cam.matrices().projection_view_matrix)


def _dither():
    jd = jnoise(H, W, jnp.int32(NOISE_INDEX))[..., 0]
    td = tnoise(H, W, NOISE_INDEX)[..., 0]
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    return jd, td


@pytest.mark.parametrize("cnmf", [0.0, 3.0, 20.0])
@pytest.mark.parametrize("case,peels", [("material", 3), ("alpha_map", 3),
                                        ("cutouts", 3), ("cutouts", 5)])
def test_rasterizers_match_jax(case, peels, cnmf):
    """``rasterize_gbuffer`` on the jittered camera, with its visibility's
    winner ids (``return_ids``), and ``rasterize_velocity`` (its own alpha
    scan on the unjittered camera, the previous one a step back) with the
    dither and ``alpha_peels`` = ``peels``, both packages as their
    composers run them. The velocity pass runs on the two textured
    scenes at 3 peels (the material-alpha route is the G-buffer's
    visibility call): each JAX compile of a raster costs seconds."""
    jscene, eye, target = SCENES[case](jre)
    tscene = SCENES[case](tre)[0]
    jpacked, tpacked = jscene.pack(), tscene.pack("cpu")
    assert (jr._alpha_inputs(jpacked, 0)[1] is None) == (case == "material")
    jd, td = _dither()
    vp = _view_proj(eye, target, jitter=3)
    mm = jscene.model_matrices()
    jgb, jids = jr.rasterize_gbuffer(jpacked, mm, vp, H, W, dither=jd,
                                     cnmf=jnp.float32(cnmf), alpha_peels=peels,
                                     return_ids=True)
    tgb, tids = tr.rasterize_gbuffer(tpacked, mm, vp, H, W, dither=td, cnmf=cnmf,
                                     alpha_peels=peels, return_ids=True)
    ids_j, ids = np.asarray(jids), tids.numpy()
    same = ids == ids_j
    assert (~same).mean() <= FLIP_FRAC, (~same).sum()
    err = lambda a, b, s: np.abs(a.numpy() - np.asarray(b)).reshape(H, W, -1).max(-1)[s]
    for f in ("diffuse", "roughness", "metalness", "emissive"):
        assert err(getattr(tgb, f), getattr(jgb, f), same).max(initial=0.0) <= 1e-6
    assert err(tgb.depth, jgb.depth, same).max() <= 5e-5
    assert err(tgb.normal, jgb.normal, same).max() <= 1e-3
    assert 0.05 < (ids_j >= 0).mean() < 1.0
    if case == "cutouts":    # the holes, over the floor's faces
        hole = ids_j[28:36, 44:52]
        assert (hole < 2).all() and ((hole == -1).all() == (peels == 3))
    if cnmf == 0.0 and case == "alpha_map":   # the hard cut: alpha 0.1 drops out
        assert (ids[:, : W // 2 - 12] == -1).mean() > 0.9
    if peels != 3 or case == "material":
        return
    vp_now = _view_proj(eye, target)
    vp_prev = _view_proj((eye[0] + 0.05, eye[1], eye[2] - 0.04), target)
    jvel = jr.rasterize_velocity(jpacked, mm, mm, vp_now, vp_prev, H, W,
                                 dither=jd, cnmf=jnp.float32(cnmf))
    tvel = tr.rasterize_velocity(tpacked, mm, mm, vp_now, vp_prev, H, W,
                                 dither=td, cnmf=cnmf)
    covered = tvel.depth.numpy() < 1.0
    vsame = covered == (np.asarray(jvel.depth) < 1.0)
    assert (~vsame).mean() <= FLIP_FRAC
    both = vsame & covered
    assert err(tvel.velocity, jvel.velocity, both).max() <= 5e-5
    assert err(tvel.depth, jvel.depth, both).max() <= 1e-4
    assert err(tvel.normal, jvel.normal, both).max() <= 1e-3
