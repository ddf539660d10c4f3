"""The port's glTF, animation and Draco loaders vs the JAX package's, on
the CPU. All are numpy copies, so every comparison is exact.

- ``write_glb`` of meshes built in code (a textured box whose alpha map
  makes it ``BLEND``, a plane of material alpha 0.5, an emissive sphere,
  each under its own matrix): the same bytes from both packages, and
  ``load_gltf`` / ``load_gltf_asset`` of that file give the same meshes,
  materials (the ``alphaMode`` -> ``alpha_map`` conversion included),
  node hierarchy and animations.
- ``AnimationMixer``: a two-node hierarchy with translation (LINEAR),
  rotation (LINEAR, slerp), scale (STEP) and morph-weight (CUBICSPLINE)
  channels loaded from a glTF document, plus a clip built in code and
  appended to ``asset.animations``; the meshes' matrices, previous
  matrices and morph weights after each of several ``update(dt)`` calls.
- Draco: synthetic streams from ``tools/draco_testgen.py`` (difference,
  parallelogram and constrained-multi-parallelogram position prediction,
  portable texcoords) through the port's C++ decoder
  (``native.draco_decode``), its Python decoder and the JAX package's,
  and a GLB whose primitive carries ``KHR_draco_mesh_compression``
  through both loaders.
"""

import base64
import json
import os
import struct
import sys

import numpy as np
import pytest

import realism_effects_tpu as jre
from realism_effects_tpu.scene import animation as janim
from realism_effects_tpu.scene import draco as jdraco
import realism_effects_tpu_torch as tre
from realism_effects_tpu_torch import native
from realism_effects_tpu_torch.scene import animation as tanim
from realism_effects_tpu_torch.scene import draco as tdraco

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import draco_testgen as G  # noqa: E402

_MESH_FIELDS = ("positions", "normals", "faces", "uvs", "matrix_world",
                "skin_indices", "skin_weights", "morph_positions",
                "morph_normals")
_MAT_FIELDS = ("diffuse", "roughness", "metalness", "emissive", "map",
               "emissive_map", "alpha_map", "normal_map", "normal_scale",
               "mr_map", "ao_map", "ao_strength")


def _meshes(m):
    rng = np.random.default_rng(5)
    tex = rng.uniform(0.0, 1.0, (8, 8, 4)).astype(np.float32)
    cut = np.ones((8, 8, 4), np.float32)
    cut[..., 1] = (np.indices((8, 8)).sum(0) % 2).astype(np.float32)
    box = m.make_box((1, 2, 1), m.Material(diffuse=(0.9, 0.3, 0.2, 1.0),
                                           map=tex, alpha_map=cut,
                                           roughness=0.4, metalness=0.1))
    box.set_matrix(m.translation(0.5, 1.0, -0.2) @ m.rotation_y(0.7))
    plane = m.make_plane(4, m.Material(diffuse=(0.6, 0.6, 0.65, 0.5)))
    sph = m.make_sphere(0.5, 12, 8, material=m.Material(
        diffuse=(0.2, 0.5, 0.9, 1.0), emissive=(0.5, 0.2, 0.1),
        emissive_map=tex[..., :3]))
    sph.set_matrix(m.translation(1.5, 0.5, 0.5))
    return [box, plane, sph]


def _same(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
    elif isinstance(a, (tuple, float, int)):
        assert np.array_equal(np.asarray(a), np.asarray(b)), what
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


def _same_meshes(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for f in _MESH_FIELDS:
            _same(getattr(g, f, None), getattr(w, f, None), f"mesh {i}.{f}")
        for f in _MAT_FIELDS:
            _same(getattr(g.material, f), getattr(w.material, f), f"mesh {i}.material.{f}")


def test_write_glb_and_loaders_match_jax(tmp_path):
    tpath, jpath = str(tmp_path / "port.glb"), str(tmp_path / "jax.glb")
    tre.write_glb(_meshes(tre), tpath)
    jre.write_glb(_meshes(jre), jpath)
    with open(tpath, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    got, want = tre.load_gltf(jpath), jre.load_gltf(jpath)
    _same_meshes(got, want)
    assert got[0].material.alpha_map is not None          # BLEND -> alpha_map
    assert got[1].material.diffuse[3] == 0.5 and got[1].material.alpha_map is None
    tasset, jasset = tre.load_gltf_asset(jpath), jre.load_gltf_asset(jpath)
    assert isinstance(tasset, tre.GltfAsset)
    _same_meshes(tasset.meshes, jasset.meshes)
    for f in ("node_translation", "node_rotation", "node_scale", "node_parent"):
        _same(np.asarray(getattr(tasset, f)), np.asarray(getattr(jasset, f)), f)
    assert tasset.node_meshes == jasset.node_meshes and tasset.animations == []
    scene = tre.Scene()
    for mesh in got:
        scene.add(mesh)
    assert scene.pack("cpu").has_alpha


def _anim_doc():
    """A glTF document (data-URI buffer): a root node with a child, each
    holding a one-triangle mesh (the child's with two morph targets), and
    one animation with a channel of each path and interpolation kind."""
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    d1 = np.array([[0, 0, 0.5], [0, 0, 0], [0, 0, 0]], np.float32)
    d2 = np.array([[0, 0, 0], [0.3, 0, 0], [0, 0, 0]], np.float32)
    t = np.array([0.0, 0.5, 1.5], np.float32)
    tr_vals = np.array([[0, 0, 0], [1, 0, 0], [1, 2, 0]], np.float32)
    q = lambda a: [0.0, np.sin(a / 2), 0.0, np.cos(a / 2)]
    rot_vals = np.array([q(0.0), q(1.0), q(2.5)], np.float32)
    sc_vals = np.array([[1, 1, 1], [2, 1, 1], [1, 1, 3]], np.float32)
    # CUBICSPLINE: (in-tangent, value, out-tangent) per key, 2 weights each
    w_vals = np.array([[0, 0], [0, 0], [1, -1], [2, 1], [1, 0.5], [0, 0],
                       [0, 0], [0.2, 0.8], [0, 0]], np.float32)
    blobs = [pos, d1, d2, t, tr_vals, rot_vals, sc_vals, w_vals]
    raw = b"".join(b.tobytes() for b in blobs)
    views, accessors, off = [], [], 0
    kinds = ["VEC3", "VEC3", "VEC3", "SCALAR", "VEC3", "VEC4", "VEC3", "SCALAR"]
    for b, kind in zip(blobs, kinds):
        views.append({"buffer": 0, "byteOffset": off, "byteLength": b.nbytes})
        n = b.size // {"VEC3": 3, "VEC4": 4, "SCALAR": 1}[kind]
        acc = {"bufferView": len(views) - 1, "componentType": 5126, "count": n,
               "type": kind}
        if len(accessors) in (0, 3):
            acc.update(min=b.reshape(n, -1).min(0).tolist(),
                       max=b.reshape(n, -1).max(0).tolist())
        accessors.append(acc)
        off += b.nbytes
    sampler = lambda out, interp: {"input": 3, "output": out, "interpolation": interp}
    return {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "children": [1], "translation": [0, 0.5, 0]},
                  {"mesh": 1, "translation": [1, 0, 0], "weights": [0.0, 0.0]}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}}]},
                   {"primitives": [{"attributes": {"POSITION": 0},
                                    "targets": [{"POSITION": 1}, {"POSITION": 2}]}],
                    "weights": [0.0, 0.0]}],
        "accessors": accessors, "bufferViews": views,
        "buffers": [{"uri": "data:application/octet-stream;base64,"
                     + base64.b64encode(raw).decode(), "byteLength": len(raw)}],
        "animations": [{"name": "walk", "samplers": [
            sampler(4, "LINEAR"), sampler(5, "LINEAR"), sampler(6, "STEP"),
            sampler(7, "CUBICSPLINE")], "channels": [
            {"sampler": 0, "target": {"node": 0, "path": "translation"}},
            {"sampler": 1, "target": {"node": 1, "path": "rotation"}},
            {"sampler": 2, "target": {"node": 1, "path": "scale"}},
            {"sampler": 3, "target": {"node": 1, "path": "weights"}}]}],
    }


def test_animation_mixer_matches_jax(tmp_path):
    path = str(tmp_path / "anim.gltf")
    with open(path, "w") as f:
        json.dump(_anim_doc(), f)
    runs = []
    for m, anim in ((tre, tanim), (jre, janim)):
        asset = m.load_gltf_asset(path)
        assert [c.name for c in asset.animations] == ["walk"]
        bob = anim.AnimationClip(name="bob", channels=[anim.AnimationChannel(
            node=1, path="translation", times=np.array([0.0, 0.4, 0.8]),
            values=np.array([[1, 0, 0], [1, 0.25, 0], [1, 0, 0]], np.float64))])
        asset.animations.append(bob)
        mixer = m.AnimationMixer(asset)
        for clip in asset.animations:
            mixer.clip_action(clip).play()
        states = []
        for dt in (0.1, 0.25, 0.3, 0.6, 0.9):   # past the clip's end: it loops
            mixer.update(dt)
            states.append([(np.asarray(mesh.matrix_world).copy(),
                            np.asarray(mesh.prev_matrix_world).copy(),
                            None if mesh.morph_weights is None
                            else np.asarray(mesh.morph_weights).copy())
                           for mesh in asset.meshes])
        runs.append(states)
    moved = 0
    for step_t, step_j in zip(*runs):
        for (mt, pt, wt), (mj, pj, wj) in zip(step_t, step_j):
            np.testing.assert_array_equal(mt, mj)
            np.testing.assert_array_equal(pt, pj)
            _same(wt, wj, "morph weights")
            moved += int(not np.array_equal(mt, pt))
    assert moved >= 8


def _streams():
    """(stream, expected point attributes by uid) of synthetic Draco
    bitstreams, the recipes of ``tests/test_draco.py::TestSyntheticStreams``."""
    bits, vmax = 11, (1 << 11) - 1

    def entries(ctx, vals, nc):
        view, v2c, vert2val, c2p, num_points = ctx
        pc = np.full(num_points, -1, np.int64)
        for c in range(len(c2p) - 1, -1, -1):
            pc[c2p[c]] = c
        ent = np.asarray([vert2val[view.cv[c]] for c in pc])
        return np.asarray(vals, np.float32).reshape(-1, nc)[ent]

    def pos_vals(ctx, seed=42):
        return np.random.default_rng(seed).integers(0, vmax + 1, len(ctx[1]) * 3)

    out = []
    ctx = G.connectivity_context(8)
    vals = pos_vals(ctx)
    for method in (0, 1):
        corr, _ = (G.author_difference(vals, 3, 0, vmax) if method == 0
                   else G.author_parallelogram(vals, 3, ctx, 0, vmax))
        data = G.quantized_data_block(corr, method, 3, b"", bits)
        out.append((G.assemble(8, [(G.desc_table(0, 3, 0, 2), data)]),
                    {0: entries(ctx, vals, 3)}))
    symbols = G.fan_connectivity(5)
    ctx = G.connectivity_context(symbols)
    vals = pos_vals(ctx)
    corr, crease = G.author_constrained_multi(vals, 3, ctx, 0, vmax, crease_every=2)
    sd = b""
    for b in crease:
        sd += G.varint(len(b)) + (G.rans_bit_stream(list(b.astype(int))) if len(b) else b"")
    out.append((G.assemble(symbols, [(G.desc_table(0, 3, 0, 2),
                                      G.quantized_data_block(corr, 4, 3, sd, bits))]),
                {0: entries(ctx, vals, 3)}))
    uv_vals = pos_vals(ctx, seed=7)[: len(ctx[1]) * 2]
    pos_corr, _ = G.author_difference(vals, 3, 0, vmax)
    uv_corr, orient = G.author_texcoords(uv_vals, ctx, 0, vmax, vals.reshape(-1, 3))
    sd = struct.pack("<I", len(orient)) + G.rans_bit_stream(G.orientation_bits(orient))
    out.append((G.assemble(symbols, [
        (G.desc_table(0, 3, 0, 2), G.quantized_data_block(pos_corr, 0, 3, b"", bits)),
        (G.desc_table(3, 2, 1, 2), G.quantized_data_block(uv_corr, 5, 2, sd, bits))]),
        {0: entries(ctx, vals, 3), 1: entries(ctx, uv_vals, 2)}))
    return out


def test_draco_decoders_match_jax():
    assert native.draco_available()
    for stream, expect in _streams():
        want = jdraco.decode_py(stream)
        for got in (tdraco.decode_py(stream), tdraco.decode(stream)):
            np.testing.assert_array_equal(got.faces, want.faces)
            assert got.num_points == want.num_points
            for uid, arr in want.attributes.items():
                np.testing.assert_array_equal(got.attributes[uid], arr)
                np.testing.assert_array_equal(arr, expect[uid])
        faces, attrs, n = native.draco_decode(stream)
        assert n == want.num_points and np.array_equal(faces, want.faces)
        for uid, arr in want.attributes.items():
            np.testing.assert_array_equal(np.asarray(attrs[uid], np.float64),
                                          np.asarray(arr, np.float64))
    with pytest.raises(ValueError):
        native.draco_decode(b"DRACO\x02\x02\x01\x00\x00\x00" + bytes(16))


def test_draco_glb_loads_in_both_packages(tmp_path):
    """A GLB whose one primitive is a Draco stream (positions and
    texcoords; normals computed from the faces)."""
    stream, _ = _streams()[-1]
    blob = stream + b"\x00" * ((-len(stream)) % 4)
    mesh = jdraco.decode_py(stream)
    n = mesh.num_points
    doc = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "translation": [0, 1, 0]}],
        "extensionsUsed": ["KHR_draco_mesh_compression"],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "TEXCOORD_0": 1},
            "extensions": {"KHR_draco_mesh_compression": {
                "bufferView": 0, "attributes": {"POSITION": 0, "TEXCOORD_0": 1}}}}]}],
        "accessors": [{"componentType": 5126, "count": n, "type": "VEC3",
                       "min": [0, 0, 0], "max": [2047, 2047, 2047]},
                      {"componentType": 5126, "count": n, "type": "VEC2"}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": len(stream)}],
        "buffers": [{"byteLength": len(blob)}],
    }
    js = json.dumps(doc).encode()
    js += b" " * ((-len(js)) % 4)
    path = str(tmp_path / "draco.glb")
    with open(path, "wb") as f:
        f.write(struct.pack("<4sII", b"glTF", 2, 28 + len(js) + len(blob)))
        f.write(struct.pack("<I4s", len(js), b"JSON") + js)
        f.write(struct.pack("<I4s", len(blob), b"BIN\x00") + blob)
    got, want = tre.load_gltf(path), jre.load_gltf(path)
    _same_meshes(got, want)
    assert got[0].faces.shape == mesh.faces.shape
