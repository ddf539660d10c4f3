"""The port's rasterizer and its two kernels' plain versions vs the JAX
package, on the CPU.

- The z-scan's plain version against the JAX package's Pallas z-scan
  (``zscan_visibility``, run in interpret mode as its own tests run Pallas
  kernels off the TPU) on the same per-triangle arrays. Both hoist the
  interpolants per triangle, and the port builds its table in the order
  XLA:CPU sums the einsums (an FMA chain): measured, the same winners and
  the same depth. A host whose XLA did not contract those sums would
  move the table by an ulp (a plain sum measured 1.2e-5 in depth), so
  the bounds are those of the scan below. A scene above 4096 triangles
  goes through the TPU kernel's min-combined batches on the JAX side and
  one pass here.
- The port's visibility against the JAX package's scan (the CPU path of
  ``_visibility``), on the JAX clip positions: depth to 5e-5 (the
  per-pixel sums against the hoisted planes; measured 2.2e-5) and at
  most 0.1% of pixels with another winner (measured: none, from the
  orbit and from inside the geometry; the box's bottom face is coplanar
  with the ground, so a winner there rests on an ulp of z).
- The record fetch's plain version against ``vmem_table_lookup``: equal.
- ``rasterize_gbuffer`` / ``rasterize_velocity`` against the JAX package's
  (jitted, as the composer runs them). The JAX side resolves visibility
  by its per-pixel scan on the CPU, and XLA's fused plane evaluations
  round in another order than the port's, an ulp that the edge planes
  magnify near silhouettes: per plane, where both pick the same winner,
  material planes equal, depth 1e-4, normals 1e-3 with at most 1% of
  pixels off by more than 1e-4, velocity 5e-5, uv-sampled texture planes
  1e-3 with at most 1% of pixels off by more than 1e-4. Measured over the
  six cases: depth 2.3e-5, normals 2.4e-4 (0.03% of pixels above 1e-4),
  velocity 1.2e-5, texture planes 3.8e-4 (0.15% above 1e-4). Winners may
  flip at no more than 0.1% of pixels (measured: none).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realism_effects_tpu as jre
from realism_effects_tpu.ops.pallas import raster as jraster
from realism_effects_tpu.ops.pallas import table as jtable
from realism_effects_tpu.scene import rasterizer as jr
import realism_effects_tpu_torch as tre
from realism_effects_tpu_torch import convert
from realism_effects_tpu_torch.ops import raster_kernel, table_kernel
from realism_effects_tpu_torch.scene import rasterizer as tr

H, W = 64, 96
FLIP_FRAC = 1e-3
_GB_EXACT = ("diffuse", "roughness", "metalness", "emissive", "mesh_id")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flagship(m, segments=(24, 16)):
    scene = m.Scene()
    scene.add(m.make_plane(20, m.Material(diffuse=(0.6, 0.6, 0.65, 1.0))))
    box = scene.add(m.make_box((1, 1, 1), m.Material(diffuse=(0.9, 0.3, 0.2, 1.0))))
    box.set_matrix(m.translation(0, 0.5, 0))
    sph = scene.add(m.make_sphere(0.6, *segments, material=m.Material(
        diffuse=(0.2, 0.5, 0.9, 1.0), roughness=0.2, metalness=0.8)))
    sph.set_matrix(m.translation(1.5, 0.6, 0.5))
    return scene


def _view_proj(eye, target=(0, 0.5, 0), jitter=None):
    cam = jre.PerspectiveCamera(50, W / H, 0.1, 100)
    cam.set_position(*eye)
    cam.look_at(target)
    if jitter is not None:
        cam.jitter(W, H, jitter)
    return np.asarray(cam.matrices().projection_view_matrix)


ORBIT = (3.0, 2.5, 4.0)
INSIDE = ((0.2, 0.4, 0.2), (2, 0.5, 1))


def _jax_clip(scene, vp):
    world, _ = jr._world_transform(scene.pack(), scene.model_matrices())
    return jr._clip_positions(world, vp)


# --- the z-scan ---------------------------------------------------------

def _interpreted_zscan(monkeypatch, clip, faces, h, w):
    """JAX ``_visibility`` through its Pallas z-scan in interpret mode;
    returns (ids, depth01, the kernel's per-triangle arguments)."""
    args = []
    real = jraster.zscan_visibility

    def record(*a):
        args.append([np.asarray(x) for x in a[:6]])
        return real(*a)

    monkeypatch.setattr(jraster.pl, "pallas_call",
                        functools.partial(jraster.pl.pallas_call, interpret=True))
    monkeypatch.setattr(jraster, "zscan_visibility", record)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    ids, depth = jr._visibility(clip, faces, h, w)
    monkeypatch.undo()
    return np.asarray(ids), np.asarray(depth), args[0]


@pytest.mark.parametrize("view", ["orbit", "inside", "dense"])
def test_zscan_plain_matches_pallas_kernel(monkeypatch, view):
    """Per-triangle arrays recorded from the JAX kernel call go through
    the port's table build and plain z-scan."""
    scene = _flagship(jre, (96, 32) if view == "dense" else (24, 16))
    eye, target = INSIDE if view == "inside" else (ORBIT, (0, 0.5, 0))
    clip = _jax_clip(scene, _view_proj(eye, target))
    faces = scene.pack().faces
    if view == "dense":
        assert faces.shape[0] > 4096  # batched on the TPU kernel
    ids_k, depth_k, args = _interpreted_zscan(monkeypatch, clip, faces, H, W)
    t = [torch.tensor(a) for a in args]
    t[4] = t[4].bool()
    ids, z = raster_kernel.zscan_visibility(*t, H, W)
    depth = torch.where(ids >= 0, z * 0.5 + 0.5, 1.0).numpy()
    same = ids.numpy() == ids_k
    assert (~same).mean() <= FLIP_FRAC
    np.testing.assert_allclose(depth[same], depth_k[same], rtol=0, atol=5e-5)
    assert (ids_k >= 0).mean() > 0.5


@pytest.mark.parametrize("view", ["orbit", "inside"])
def test_visibility_matches_jax_scan(view):
    scene = _flagship(jre)
    eye, target = INSIDE if view == "inside" else (ORBIT, (0, 0.5, 0))
    clip = _jax_clip(scene, _view_proj(eye, target))
    ids_s, depth_s = (np.asarray(a) for a in
                      jr._visibility(clip, scene.pack().faces, H, W))
    ids, depth = tr._visibility(torch.tensor(np.asarray(clip)),
                                torch.tensor(np.asarray(scene.pack().faces)), H, W)
    same = ids.numpy() == ids_s
    assert (~same).mean() <= FLIP_FRAC
    np.testing.assert_allclose(depth.numpy()[same], depth_s[same], rtol=0, atol=5e-5)


def test_lookup_plain_matches_vmem_table_lookup():
    rng = np.random.default_rng(3)
    table = rng.normal(size=(5, 128, 8)).astype(np.float32)
    ids = rng.integers(-5, 5 * 128 + 50, (H, W)).astype(np.int32)
    safe = np.maximum(ids, 0)
    want = np.asarray(jtable.vmem_table_lookup(
        jnp.asarray(table), jnp.asarray(safe // 128), jnp.asarray(safe % 128)))
    got = table_kernel.face_lookup_plain(torch.from_numpy(table),
                                         torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)


# --- rasterize_gbuffer / rasterize_velocity --------------------------------

def _textured(m):
    rng = np.random.default_rng(11)
    tex = lambda c=4: rng.uniform(0.2, 1.0, (16, 16, c)).astype(np.float32)
    scene = m.Scene()
    scene.add(m.make_plane(4, m.Material(
        map=tex(), emissive_map=tex(3), mr_map=tex(), normal_map=tex(3),
        ao_map=tex(), ao_strength=0.7, normal_scale=0.8)))
    box = scene.add(m.make_box((1, 1, 1), m.Material(map=tex(3))))
    box.set_matrix(m.translation(0.3, 0.5, -0.2))
    return scene


def _skinned(m):
    scene = _flagship(m)
    box = scene.meshes[1]
    nv = len(box.positions)
    box.skin_indices = np.zeros((nv, 4), np.int32)
    box.skin_indices[:, 1] = 1
    box.skin_weights = np.zeros((nv, 4), np.float32)
    up = box.positions[:, 1] > 0
    box.skin_weights[:, 0] = np.where(up, 0.3, 1.0)
    box.skin_weights[:, 1] = np.where(up, 0.7, 0.0)
    box.set_bones(np.stack([np.eye(4), m.translation(0, 0, 0)]))
    box.set_bones(np.stack([np.eye(4), m.translation(0.2, 0.1, 0) @ m.rotation_y(0.3)]))
    return scene


def _morphed(m):
    scene = _flagship(m)
    sph = scene.meshes[2]
    rng = np.random.default_rng(12)
    sph.morph_positions = (rng.normal(0, 0.05, (2,) + sph.positions.shape)
                           .astype(np.float32))
    sph.morph_normals = (rng.normal(0, 0.05, (2,) + sph.normals.shape)
                         .astype(np.float32))
    sph.set_morph_weights([0.2, 0.5])
    sph.set_morph_weights([0.6, 0.1])
    return scene


SCENES = {"flagship": _flagship, "textured": _textured, "skinned": _skinned,
          "morphed": _morphed}


def _frame_inputs(scene):
    bones = prev_bones = morph = prev_morph = None
    if scene.num_bones() > 1:
        bones, prev_bones = scene.bone_matrices(), scene.bone_matrices(prev=True)
    if scene.max_morph_targets() > 0:
        morph = scene.morph_weight_matrix()
        prev_morph = scene.morph_weight_matrix(prev=True)
    return dict(bones=bones, prev_bones=prev_bones, morph=morph,
                prev_morph=prev_morph)


def _run(mod, scene, packed, kind, share=False, face_keep=None):
    """(G-buffer, ids, velocity) of ``scene`` by the package ``mod``
    (jr or tr) on the jittered camera of frame 3 (velocity: unjittered,
    previous camera one orbit step back)."""
    f = _frame_inputs(scene)
    vp = _view_proj(ORBIT, jitter=3)
    vp_now = _view_proj(ORBIT)
    vp_prev = _view_proj((3.08, 2.5, 3.95))
    mm, pmm = scene.model_matrices(), scene.prev_model_matrices()
    gb_kw = dict(bones=f["bones"], morph_weights=f["morph"], return_ids=True)
    if face_keep is not None:
        gb_kw["face_keep"] = face_keep
    gb, ids = mod.rasterize_gbuffer(packed, mm, vp, H, W, **gb_kw)
    vel = mod.rasterize_velocity(
        packed, mm, pmm, vp_now, vp_prev, H, W, bones=f["bones"],
        prev_bones=f["prev_bones"], morph_weights=f["morph"],
        prev_morph_weights=f["prev_morph"], share_ids=ids if share else None)
    return gb, ids, vel


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _near(got, want, same, atol, tight=None, frac=0.0):
    """Within ``atol`` where both picked the same winner, and at most
    ``frac`` of those pixels off by more than ``tight``."""
    err = np.abs(_np(got).astype(np.float64) - _np(want))
    if err.ndim == 3:
        err = err.max(-1)
    err = err[same]
    assert err.max(initial=0.0) <= atol, err.max()
    if tight is not None:
        assert (err > tight).mean() <= frac, (err > tight).mean()


@pytest.mark.parametrize("case", ["flagship", "textured", "skinned", "morphed",
                                  "share_ids", "face_keep"])
def test_rasterizers_match_jax(case):
    make = SCENES.get(case, _flagship)
    jscene, tscene = make(jre), make(tre)
    jpacked = jscene.pack()
    tpacked = tscene.pack("cpu")
    for k in tpacked.__dataclass_fields__:
        if k != "has_alpha":
            np.testing.assert_array_equal(getattr(tpacked, k).numpy(),
                                          np.asarray(getattr(jpacked, k)))
    keep = None
    if case == "face_keep":
        keep = np.asarray(jpacked.vert_mesh_id)[np.asarray(jpacked.faces)[:, 0]] != 1
    share = case == "share_ids"
    jgb, jids, jvel = _run(jr, jscene, jpacked, case, share,
                           None if keep is None else jnp.asarray(keep))
    tgb, tids, tvel = _run(tr, tscene, tpacked, case, share,
                           None if keep is None else torch.from_numpy(keep))
    same = _np(tids) == _np(jids)
    assert (~same).mean() <= FLIP_FRAC
    if keep is not None:
        assert not np.isin(_np(tgb.mesh_id), [1]).any()
    tex = case == "textured"
    for f in _GB_EXACT:
        if tex and f != "mesh_id":
            _near(getattr(tgb, f), getattr(jgb, f), same, 1e-3, 1e-4, 0.01)
        else:
            _near(getattr(tgb, f), getattr(jgb, f), same, 1e-6)
    _near(tgb.depth, jgb.depth, same, 1e-4)
    _near(tgb.normal, jgb.normal, same, 1e-3, 1e-4, 0.01)
    assert (tgb.ao is None) == (jgb.ao is None)
    if tex:
        _near(tgb.ao, jgb.ao, same, 1e-3, 1e-4, 0.01)
    _near(tvel.velocity, jvel.velocity, same, 5e-5)
    _near(tvel.normal, jvel.normal, same, 1e-3, 1e-4, 0.01)
    _near(tvel.depth, jvel.depth, same, 1e-4)
    moving = np.abs(_np(tvel.velocity)).max(-1) > 1e-4
    assert moving.mean() > 0.2


def test_alpha_scene_raises():
    """An alpha scene no longer raises: without a ``dither`` it rasterizes
    opaque, as the JAX package's does (the same winners); with one it
    takes the stochastic-alpha route (``tests/test_torch_alpha.py``), and
    on a hard-cut frame (cnmf 0) the box of alpha 0.4 drops out. The
    flag that routes it is set at packing."""
    jscene, tscene = _flagship(jre), _flagship(tre)
    for s in (jscene, tscene):
        s.meshes[1].material.diffuse = (0.9, 0.3, 0.2, 0.4)
    vp = _view_proj(ORBIT)
    tpacked = tscene.pack("cpu")
    assert tpacked.has_alpha
    opaque = tr.rasterize_gbuffer(tpacked, tscene.model_matrices(), vp, H, W)
    jgb = jr.rasterize_gbuffer(jscene.pack(), jscene.model_matrices(), vp, H, W)
    same = opaque.mesh_id.numpy() == np.asarray(jgb.mesh_id)
    assert (~same).mean() <= FLIP_FRAC and bool((opaque.mesh_id == 1).any())
    dither = torch.zeros((H, W))
    cut = tr.rasterize_gbuffer(tpacked, tscene.model_matrices(), vp, H, W,
                               dither=dither, cnmf=0.0)
    assert not bool((cut.mesh_id == 1).any())
    assert convert.packed_scene_from_numpy(
        _flagship(jre).pack(), "cpu").has_alpha is False
