"""The port's Scene packing and lighting parameters vs the JAX package's:
exactly equal (the same numpy code builds them)."""

import numpy as np
import pytest
import torch

import realism_effects_tpu as jre
import realism_effects_tpu_torch as tre
from realism_effects_tpu_torch import convert
from realism_effects_tpu_torch.scene.scene import _PACKED_DTYPES


def _scene(m, kind):
    scene = m.Scene(background_color=(0.1, 0.2, 0.3))
    scene.add(m.make_plane(20, m.Material(diffuse=(0.6, 0.6, 0.65, 1.0))))
    box = scene.add(m.make_box((1, 2, 1), m.Material(diffuse=(0.9, 0.3, 0.2, 1.0),
                                                     emissive=(0.1, 0, 0))))
    box.set_matrix(m.translation(0, 0.5, 0) @ m.rotation_y(0.4))
    sph = scene.add(m.make_sphere(0.6, 12, 8, material=m.Material(
        diffuse=(0.2, 0.5, 0.9, 1.0), roughness=0.2, metalness=0.8)))
    sph.set_matrix(m.translation(1.5, 0.6, 0.5))
    rng = np.random.default_rng(4)
    if kind == "skinned":
        nv = len(box.positions)
        box.skin_indices = rng.integers(0, 3, (nv, 4)).astype(np.int32)
        w = rng.random((nv, 4)).astype(np.float32)
        box.skin_weights = w / w.sum(-1, keepdims=True)
        box.set_bones(np.stack([np.eye(4)] * 3))
        box.set_bones(np.stack([m.translation(0.1 * i, 0, 0) for i in range(3)]))
    elif kind == "morphed":
        sph.morph_positions = rng.normal(size=(3,) + sph.positions.shape).astype(np.float32)
        sph.morph_normals = rng.normal(size=(3,) + sph.normals.shape).astype(np.float32)
        sph.set_morph_weights([0.1, 0.2, 0.3])
        sph.set_morph_weights([0.4, 0.0, 0.3])
    elif kind == "textured":
        box.material.map = rng.random((9, 7, 3)).astype(np.float32)
        sph.material.normal_map = rng.random((5, 5, 4)).astype(np.float32)
        scene.meshes[0].visible = False
    scene.sun_specular = 0.5
    scene.add_point_light((1, 2, 1), color=(1, 0.5, 0.2), intensity=3.0,
                          distance=5.0)
    scene.add_point_light((-1, 1, 2))
    return scene


@pytest.mark.parametrize("kind", ["flagship", "skinned", "morphed", "textured"])
def test_pack_matches_jax(kind):
    jscene, tscene = _scene(jre, kind), _scene(tre, kind)
    want = jscene.pack()
    got = tscene.pack("cpu")
    assert set(_PACKED_DTYPES) == set(got.__dataclass_fields__) - {"has_alpha"}
    for k in _PACKED_DTYPES:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
        assert getattr(got, k).dtype == _PACKED_DTYPES[k]
    carried = convert.packed_scene_from_numpy(want, "cpu")
    for k in _PACKED_DTYPES:
        assert torch.equal(getattr(carried, k), getattr(got, k))
    assert got.has_alpha is False and got.num_faces == want.num_faces
    np.testing.assert_array_equal(tscene.model_matrices(), np.asarray(jscene.model_matrices()))
    np.testing.assert_array_equal(tscene.prev_model_matrices(),
                                  np.asarray(jscene.prev_model_matrices()))
    for prev in (False, True):
        np.testing.assert_array_equal(tscene.bone_matrices(prev), jscene.bone_matrices(prev))
        np.testing.assert_array_equal(tscene.morph_weight_matrix(prev),
                                      jscene.morph_weight_matrix(prev))
    np.testing.assert_array_equal(tscene.gi_mask(), jscene.gi_mask())


@pytest.mark.parametrize("lights", [False, True])
def test_lighting_params_match_jax(lights):
    jscene, tscene = jre.Scene(), tre.Scene()
    if lights:
        for s in (jscene, tscene):
            s.sun_specular = 0.7
            s.add_point_light((1, 2, 3), color=(0.5, 1, 1), intensity=2.0, distance=4.0,
                              decay=1.5)
    want = jscene.lighting_params()
    got = tscene.lighting_params("cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_commit_frame_and_gi_mask():
    scene = _scene(tre, "morphed")
    scene.meshes[1].gi_exclude = True
    np.testing.assert_array_equal(scene.gi_mask(), [1.0, 0.0, 1.0])
    box = scene.meshes[1]
    box.set_matrix(tre.translation(1, 0, 0))
    assert not np.array_equal(scene.model_matrices(), scene.prev_model_matrices())
    scene.commit_frame()
    np.testing.assert_array_equal(scene.model_matrices(), scene.prev_model_matrices())
    np.testing.assert_array_equal(scene.morph_weight_matrix(),
                                  scene.morph_weight_matrix(prev=True))
    empty = tre.Scene().pack("cpu")
    assert empty.num_faces == 1 and empty.materials.shape == (1, 11)
