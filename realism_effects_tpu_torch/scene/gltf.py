"""Minimal glTF 2.0 loader (+ GLB writer for fixtures).

The reference's de-facto regression fixtures are glTF scenes loaded by
its demo app (`example/main.js:760-809` via three.js
GLTFLoader). This loader covers the subset the framework renders:

- .glb (binary container) and .gltf (JSON + external / data-URI buffers)
- triangle primitives: POSITION, NORMAL (computed if absent),
  TEXCOORD_0, indices; node hierarchy with baked world transforms
- pbrMetallicRoughness materials: baseColor factor/texture,
  metallic/roughness factors, emissive factor/texture; MASK/BLEND alpha
  modes map to the stochastic-alpha path (base-color texture alpha is
  converted into an ``alpha_map`` whose green channel carries alpha,
  matching `GBufferMaterial.js:57-61` semantics)

Supported extensions (everything the reference's own demo assets use):

- ``KHR_draco_mesh_compression`` via the from-scratch decoder in
  ``scene/draco.py`` / ``native/draco.cpp`` — all 18 reference .glb
  scenes (`example/public/gltf/`) load end-to-end
- ``EXT_texture_webp`` (PIL decodes WebP)
- ``KHR_texture_transform`` (offset/rotation/scale baked into UVs at
  load; per-texture ``texCoord`` set selection incl. TEXCOORD_1)

glTF skins wire into the native skinning path: JOINTS_0/WEIGHTS_0 plus
the skin's inverseBindMatrices become ``Mesh.skin_indices/skin_weights/
bone_matrices`` (bone j = globalJointTransform_j @ IBM_j, bind pose;
animate via ``Mesh.set_bones``).

Morph targets (``primitive.targets`` POSITION/NORMAL deltas with
node/mesh default weights) feed ``Mesh.morph_positions/morph_normals``,
and glTF animations (translation/rotation/scale/weights channels,
LINEAR / STEP / CUBICSPLINE samplers) load into
:class:`~.animation.AnimationClip` objects played by an
:class:`~.animation.AnimationMixer` over the retained node hierarchy —
the native analog of the reference example's three.js mixer usage
(`example/main.js:949-957`). Use
:func:`load_gltf_asset` to get the meshes *plus* the animation state.

Sparse accessors (glTF 2.0 §3.6.2.3, common for morph-target deltas)
resolve their overlay at load. Out of scope (raises/skips with a
warning): meshopt compression, other KHR extensions, non-triangle
modes.

``write_glb`` exports Mesh lists back to a valid minimal GLB — used to
generate the committed demo fixture and for loader round-trip tests.

Numpy and PIL only (PIL imported inside the calls that decode or write
images): a copy of the JAX package's ``scene/gltf.py``, whose GLBs it
reads and writes byte for byte.
"""

from __future__ import annotations

import base64
import dataclasses
import io
import json
import os
import struct
import warnings

import numpy as np

from .animation import AnimationChannel, AnimationClip, decompose_trs
from .geometry import Material, Mesh


class GltfError(ValueError):
    """Malformed or unsupported glTF input (clean parse failure)."""

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
    "MAT2": 4, "MAT3": 9, "MAT4": 16,
}


def _read_glb(data: bytes):
    magic, version, _length = struct.unpack_from("<4sII", data, 0)
    if magic != b"glTF":
        raise ValueError("not a GLB file")
    if version != 2:
        raise ValueError(f"unsupported GLB version {version}")
    offset = 12
    gltf_json, bin_chunk = None, None
    while offset < len(data):
        chunk_len, chunk_type = struct.unpack_from("<I4s", data, offset)
        body = data[offset + 8: offset + 8 + chunk_len]
        if chunk_type == b"JSON":
            gltf_json = json.loads(body)
        elif chunk_type == b"BIN\x00":
            bin_chunk = body
        offset += 8 + chunk_len + ((-chunk_len) % 4 if chunk_type == b"JSON" else 0)
    if gltf_json is None:
        raise ValueError("GLB missing JSON chunk")
    return gltf_json, bin_chunk


def _safe_join(base_dir: str, uri: str) -> str:
    """Resolve a relative resource uri, refusing paths that escape the
    asset's directory (glTF files are untrusted input; a crafted uri
    like ``../../etc/passwd`` must not read outside the asset dir)."""
    from urllib.parse import unquote

    path = os.path.normpath(os.path.join(base_dir, unquote(uri)))
    base = os.path.abspath(base_dir)
    if os.path.commonpath([os.path.abspath(path), base]) != base:
        raise GltfError(f"glTF resource uri escapes asset directory: {uri!r}")
    return path


def _load_buffers(gltf: dict, bin_chunk, base_dir: str):
    buffers = []
    for buf in gltf.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            if bin_chunk is None:
                raise GltfError("buffer references missing BIN chunk")
            buffers.append(bin_chunk)
        elif uri.startswith("data:"):
            buffers.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(_safe_join(base_dir, uri), "rb") as f:
                buffers.append(f.read())
    return buffers


def _accessor(gltf: dict, buffers, index: int) -> np.ndarray:
    acc = gltf["accessors"][index]
    n_comp = _TYPE_COUNTS[acc["type"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    count = acc["count"]
    if "bufferView" not in acc:
        out = np.zeros((count, n_comp), dtype)
    else:
        view = gltf["bufferViews"][acc["bufferView"]]
        buf = buffers[view["buffer"]]
        start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        itemsize = np.dtype(dtype).itemsize * n_comp
        stride = view.get("byteStride") or itemsize
        if stride == itemsize:
            raw = np.frombuffer(buf, dtype, count=count * n_comp,
                                offset=start)
            out = raw.reshape(count, n_comp)
        else:
            out = np.empty((count, n_comp), dtype)
            for i in range(count):
                out[i] = np.frombuffer(buf, dtype, count=n_comp,
                                       offset=start + i * stride)
    if "sparse" in acc:
        # sparse overlay (glTF 2.0 §3.6.2.3): indices+values substitute
        # into the (possibly zero-initialized) base array
        sp = acc["sparse"]
        n = sp["count"]
        out = out.copy()

        def read(block, bdtype, bcomp):
            view = gltf["bufferViews"][block["bufferView"]]
            buf = buffers[view["buffer"]]
            off = view.get("byteOffset", 0) + block.get("byteOffset", 0)
            return np.frombuffer(buf, bdtype, count=n * bcomp, offset=off)

        idx = read(sp["indices"],
                   _COMPONENT_DTYPES[sp["indices"]["componentType"]], 1)
        vals = read(sp["values"], dtype, n_comp).reshape(n, n_comp)
        out[idx.astype(np.int64)] = vals
    if acc.get("normalized"):
        info = np.iinfo(dtype)
        out = out.astype(np.float32) / float(info.max)
    return out


def _decode_image(gltf: dict, buffers, base_dir: str, index: int):
    """Image -> (H, W, 4) float32 in [0, 1], or None if undecodable."""
    try:
        from PIL import Image
    except ImportError:  # pragma: no cover
        warnings.warn("PIL unavailable; glTF textures skipped")
        return None
    img = gltf["images"][index]
    try:
        if "uri" in img:
            uri = img["uri"]
            if uri.startswith("data:"):
                raw = base64.b64decode(uri.split(",", 1)[1])
            else:
                with open(_safe_join(base_dir, uri), "rb") as f:
                    raw = f.read()
        else:
            view = gltf["bufferViews"][img["bufferView"]]
            start = view.get("byteOffset", 0)
            raw = buffers[view["buffer"]][start: start + view["byteLength"]]
        pil = Image.open(io.BytesIO(raw)).convert("RGBA")
    except Exception as e:  # unsupported codec (e.g. webp build issues)
        warnings.warn(f"glTF image {index} undecodable: {e}")
        return None
    arr = np.asarray(pil, np.float32) / 255.0
    # glTF uv origin is top-left; the framework samples row 0 = v=0
    # (bottom), so flip vertically once at load time
    return arr[::-1].copy()


def _texture_image(gltf, buffers, base_dir, tex_info, cache):
    if tex_info is None:
        return None
    tex = gltf["textures"][tex_info["index"]]
    # EXT_texture_webp stores the real image in the extension
    src = tex.get("extensions", {}).get(
        "EXT_texture_webp", {}).get("source", tex.get("source"))
    if src is None:
        return None
    if src not in cache:
        cache[src] = _decode_image(gltf, buffers, base_dir, src)
    return cache[src]


def _texture_uv_config(tex_info):
    """(texcoord_set, 3x3 uv matrix or None) for a textureInfo, per
    KHR_texture_transform (uv' = T(offset) @ R(-rotation) @ S(scale))."""
    if tex_info is None:
        return 0, None
    texcoord = tex_info.get("texCoord", 0)
    tr = tex_info.get("extensions", {}).get("KHR_texture_transform")
    if tr is None:
        return texcoord, None
    texcoord = tr.get("texCoord", texcoord)
    off = tr.get("offset", [0.0, 0.0])
    rot = tr.get("rotation", 0.0)
    scale = tr.get("scale", [1.0, 1.0])
    c, s = np.cos(rot), np.sin(rot)
    m = np.array([
        [c * scale[0], s * scale[1], off[0]],
        [-s * scale[0], c * scale[1], off[1]],
        [0.0, 0.0, 1.0],
    ])
    return texcoord, m


def _srgb_to_linear(c: np.ndarray) -> np.ndarray:
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _material(gltf, buffers, base_dir, index, cache) -> Material:
    if index is None:
        return Material()
    m = gltf["materials"][index]
    pbr = m.get("pbrMetallicRoughness", {})
    base = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])
    emissive = m.get("emissiveFactor", [0.0, 0.0, 0.0])

    base_img = _texture_image(
        gltf, buffers, base_dir, pbr.get("baseColorTexture"), cache)
    emis_img = _texture_image(
        gltf, buffers, base_dir, m.get("emissiveTexture"), cache)
    # normal / metallic-roughness / occlusion textures are linear data
    nrm_img = _texture_image(
        gltf, buffers, base_dir, m.get("normalTexture"), cache)
    mr_img = _texture_image(
        gltf, buffers, base_dir, pbr.get("metallicRoughnessTexture"), cache)
    ao_img = _texture_image(
        gltf, buffers, base_dir, m.get("occlusionTexture"), cache)

    tex = None
    alpha_map = None
    if base_img is not None:
        tex = base_img.copy()
        tex[..., :3] = _srgb_to_linear(tex[..., :3])
        if m.get("alphaMode", "OPAQUE") != "OPAQUE":
            # alpha rides the green channel of alpha_map
            # (`GBufferMaterial.js:57-61` semantics)
            a = base_img[..., 3]
            alpha_map = np.stack([a, a, a, np.ones_like(a)], -1)
        tex[..., 3] = 1.0
    if emis_img is not None:
        emis_img = emis_img.copy()
        emis_img[..., :3] = _srgb_to_linear(emis_img[..., :3])

    return Material(
        diffuse=(base[0], base[1], base[2], base[3]),
        roughness=float(pbr.get("roughnessFactor", 1.0)),
        metalness=float(pbr.get("metallicFactor", 1.0)),
        emissive=tuple(emissive),
        map=tex,
        emissive_map=emis_img,
        alpha_map=alpha_map,
        normal_map=nrm_img,
        normal_scale=float(m.get("normalTexture", {}).get("scale", 1.0)),
        mr_map=mr_img,
        ao_map=ao_img,
        ao_strength=float(
            m.get("occlusionTexture", {}).get("strength", 1.0)),
    )


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "translation" in node:
        m[:3, 3] = node["translation"]
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
        m[:3, :3] = m[:3, :3] @ r
    if "scale" in node:
        m[:3, :3] = m[:3, :3] @ np.diag(node["scale"])
    return m


def _face_normals(positions: np.ndarray, faces: np.ndarray) -> np.ndarray:
    fn = np.cross(
        positions[faces[:, 1]] - positions[faces[:, 0]],
        positions[faces[:, 2]] - positions[faces[:, 0]],
    )
    normals = np.zeros_like(positions)
    for k in range(3):
        np.add.at(normals, faces[:, k], fn)
    norm = np.linalg.norm(normals, axis=-1, keepdims=True)
    return (normals / np.maximum(norm, 1e-20)).astype(np.float32)


@dataclasses.dataclass
class GltfAsset:
    """A loaded glTF document: meshes plus the retained node hierarchy
    and animation clips (the loader-side analog of three.js' loaded
    ``gltf.scene`` + ``gltf.animations``, `example/main.js:947-957`).

    Node-local TRS state is mutable — an
    :class:`~.animation.AnimationMixer` writes sampled keyframes into it
    and calls :meth:`apply_node_transforms` to push the new globals into
    the meshes (model matrices for static nodes, bone palettes for
    skinned ones, morph weights for ``weights`` tracks)."""

    meshes: list
    animations: list
    #: per-node local TRS (mutable animation targets)
    node_translation: list
    node_rotation: list
    node_scale: list
    node_parent: np.ndarray          #: (N,) int32, -1 = root
    #: node index -> indices into ``meshes`` instantiated at that node
    node_meshes: dict
    node_skin: dict                  #: node index -> skin index
    #: skin index -> (joint node indices, (J, 4, 4) inverse bind matrices)
    skins: list
    #: node index -> current morph weights (nodes with morphed meshes)
    node_weights: dict

    def global_transforms(self) -> np.ndarray:
        """(N, 4, 4) global node matrices from the current local TRS."""
        from .animation import compose_trs
        n = len(self.node_translation)
        out = np.zeros((n, 4, 4))
        done = np.zeros(n, bool)

        def compute(i: int) -> np.ndarray:
            if not done[i]:
                local = compose_trs(self.node_translation[i],
                                    self.node_rotation[i],
                                    self.node_scale[i])
                p = int(self.node_parent[i])
                out[i] = local if p < 0 else compute(p) @ local
                done[i] = True
            return out[i]

        for i in range(n):
            compute(i)
        return out

    def apply_node_transforms(self):
        """Push current node TRS / weights into the meshes: static nodes
        get ``set_matrix(global)``, skinned nodes get
        ``set_bones(globalJoint @ IBM)`` (the glTF skinning model: the
        skinned mesh ignores its own node transform), morphed nodes get
        ``set_morph_weights``. The Mesh setters keep the previous-frame
        snapshots the velocity pass needs."""
        globals_ = self.global_transforms()
        palettes = {
            si: np.stack([globals_[j] @ ibm[k]
                          for k, j in enumerate(joints)]).astype(np.float32)
            for si, (joints, ibm) in enumerate(self.skins)
            if any(ns == si for ns in self.node_skin.values())
        }
        for node, mesh_ids in self.node_meshes.items():
            skin = self.node_skin.get(node)
            w = self.node_weights.get(node)
            for mi in mesh_ids:
                mesh = self.meshes[mi]
                if skin is not None and mesh.skin_indices is not None:
                    mesh.set_bones(palettes[skin])
                else:
                    mesh.set_matrix(globals_[node])
                if w is not None and mesh.morph_positions is not None:
                    mesh.set_morph_weights(
                        np.asarray(w, np.float32)[
                            : mesh.morph_positions.shape[0]])


def _parse_animations(gltf: dict, buffers) -> list:
    """``animations`` array -> AnimationClip list (samplers resolved to
    keyframe arrays; rotation output stays (x, y, z, w))."""
    clips = []
    for ai, anim in enumerate(gltf.get("animations", [])):
        channels = []
        for ch in anim.get("channels", []):
            target = ch["target"]
            if "node" not in target:
                continue
            samp = anim["samplers"][ch["sampler"]]
            times = _accessor(gltf, buffers, samp["input"]) \
                .reshape(-1).astype(np.float64)
            values = _accessor(gltf, buffers, samp["output"]) \
                .astype(np.float64)
            interp = samp.get("interpolation", "LINEAR")
            n = len(times)
            # CUBICSPLINE stores (in-tangent, value, out-tangent) triples
            values = (values.reshape(n, 3, -1) if interp == "CUBICSPLINE"
                      else values.reshape(n, -1))
            channels.append(AnimationChannel(
                node=target["node"], path=target["path"], times=times,
                values=values, interpolation=interp))
        clips.append(AnimationClip(
            name=anim.get("name", f"clip_{ai}"), channels=channels))
    return clips


def load_gltf(path: str) -> list[Mesh]:
    """Load a .glb/.gltf file into a flat list of :class:`Mesh` with node
    transforms baked into ``matrix_world``. Add them to a Scene with
    ``for m in load_gltf(p): scene.add(m)``. For animations / the node
    hierarchy use :func:`load_gltf_asset`."""
    return load_gltf_asset(path).meshes


def load_gltf_asset(path: str) -> GltfAsset:
    """Load a .glb/.gltf file with its node hierarchy and animations.

    Malformed input raises :class:`GltfError` (a ``ValueError``) — glTF
    files are untrusted, so every structural parse failure (bad chunk
    framing, out-of-range indices, short buffers, invalid JSON) is
    converted to a clean error instead of leaking implementation
    exceptions (`tests/test_gltf.py::TestMalformedInput`)."""
    try:
        return _load_gltf_asset(path)
    except GltfError:
        raise
    except (KeyError, IndexError, ValueError, TypeError, struct.error,
            EOFError, UnicodeDecodeError) as e:
        raise GltfError(
            f"malformed glTF {os.path.basename(path)!r}: "
            f"{type(e).__name__}: {e}") from e


def _load_gltf_asset(path: str) -> GltfAsset:
    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] == b"glTF":
        gltf, bin_chunk = _read_glb(data)
    else:
        try:
            gltf = json.loads(data)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise GltfError(f"not a GLB and not valid glTF JSON: {e}")
        bin_chunk = None
    if not isinstance(gltf, dict):
        raise GltfError("glTF root is not an object")

    supported = {"KHR_draco_mesh_compression", "KHR_texture_transform",
                 "EXT_texture_webp"}
    unsupported = [e for e in gltf.get("extensionsRequired", [])
                   if e not in supported]
    if unsupported:
        raise ValueError(
            f"glTF requires unsupported extensions: {unsupported}")

    buffers = _load_buffers(gltf, bin_chunk, base_dir)
    image_cache: dict = {}
    meshes: list[Mesh] = []

    # retained node table: local TRS per node + parent links (animation
    # channels overwrite individual TRS components, so "matrix" nodes are
    # decomposed once here, like three.js' Matrix4.decompose on load)
    nodes = gltf.get("nodes", [])
    node_parent = np.full(max(len(nodes), 1), -1, np.int32)
    for p, n in enumerate(nodes):
        for c in n.get("children", ()):
            node_parent[c] = p
    node_t, node_r, node_s = [], [], []
    for n in nodes:
        t, r, s = decompose_trs(_node_matrix(n))
        node_t.append(t)
        node_r.append(r)
        node_s.append(s)

    skins = []
    for skin in gltf.get("skins", []):
        joints = list(skin["joints"])
        if "inverseBindMatrices" in skin:
            ibm = _accessor(gltf, buffers, skin["inverseBindMatrices"])
            ibm = ibm.reshape(-1, 4, 4).transpose(0, 2, 1)  # column-major
        else:
            ibm = np.tile(np.eye(4), (len(joints), 1, 1))
        skins.append((joints, ibm.astype(np.float64)))

    asset = GltfAsset(
        meshes=meshes, animations=_parse_animations(gltf, buffers),
        node_translation=node_t, node_rotation=node_r, node_scale=node_s,
        node_parent=node_parent, node_meshes={}, node_skin={},
        skins=skins, node_weights={},
    )
    node_global = asset.global_transforms() if nodes else np.zeros((0, 4, 4))

    def skin_data(skin_index: int):
        """(joints global @ IBM) bone palette for a glTF skin."""
        joints, ibm = skins[skin_index]
        return np.stack([
            node_global[j] @ ibm[k] for k, j in enumerate(joints)
        ]).astype(np.float32)

    def visit(node_index: int):
        node = gltf["nodes"][node_index]
        world = node_global[node_index]
        if "mesh" in node:
            for prim in gltf["meshes"][node["mesh"]]["primitives"]:
                if prim.get("mode", 4) != 4:
                    warnings.warn("skipping non-triangle primitive")
                    continue
                attrs = prim["attributes"]
                draco_ext = prim.get("extensions", {}).get(
                    "KHR_draco_mesh_compression")
                uv_sets: dict[int, np.ndarray] = {}
                joints = weights = None
                if draco_ext is not None:
                    from .draco import decode as draco_decode
                    view = gltf["bufferViews"][draco_ext["bufferView"]]
                    buf = buffers[view["buffer"]]
                    start = view.get("byteOffset", 0)
                    decoded = draco_decode(
                        bytes(buf[start:start + view["byteLength"]]))
                    ids = draco_ext["attributes"]  # name -> draco uid
                    pos = np.asarray(
                        decoded.attributes[ids["POSITION"]], np.float32)
                    faces = decoded.faces.astype(np.int32)
                    nrm = (np.asarray(decoded.attributes[ids["NORMAL"]],
                                      np.float32)
                           if "NORMAL" in ids else _face_normals(pos, faces))
                    for name, uid in ids.items():
                        if name.startswith("TEXCOORD_"):
                            uv_sets[int(name.split("_")[1])] = np.asarray(
                                decoded.attributes[uid], np.float32)
                    if "JOINTS_0" in ids and "WEIGHTS_0" in ids:
                        joints = np.asarray(
                            decoded.attributes[ids["JOINTS_0"]], np.int32)
                        weights = np.asarray(
                            decoded.attributes[ids["WEIGHTS_0"]], np.float32)
                else:
                    pos = _accessor(gltf, buffers, attrs["POSITION"]).astype(np.float32)
                    if "indices" in prim:
                        idx = _accessor(gltf, buffers, prim["indices"])
                        faces = idx.reshape(-1, 3).astype(np.int32)
                    else:
                        faces = np.arange(len(pos), dtype=np.int32).reshape(-1, 3)
                    if "NORMAL" in attrs:
                        nrm = _accessor(gltf, buffers, attrs["NORMAL"]).astype(np.float32)
                    else:
                        nrm = _face_normals(pos, faces)
                    for name, acc in attrs.items():
                        if name.startswith("TEXCOORD_"):
                            uv_sets[int(name.split("_")[1])] = _accessor(
                                gltf, buffers, acc).astype(np.float32)
                    if "JOINTS_0" in attrs and "WEIGHTS_0" in attrs:
                        joints = _accessor(
                            gltf, buffers, attrs["JOINTS_0"]).astype(np.int32)
                        weights = _accessor(
                            gltf, buffers, attrs["WEIGHTS_0"]).astype(np.float32)
                # pick the uv set the base-color texture samples, and
                # bake any KHR_texture_transform into it
                mat_idx = prim.get("material")
                tex_info = None
                if mat_idx is not None:
                    tex_info = gltf["materials"][mat_idx].get(
                        "pbrMetallicRoughness", {}).get("baseColorTexture")
                texcoord_set, uv_matrix = _texture_uv_config(tex_info)
                uvs = None
                uv = uv_sets.get(texcoord_set, uv_sets.get(0))
                if uv is not None:
                    if uv_matrix is not None:
                        uv = (uv @ uv_matrix[:2, :2].T
                              + uv_matrix[:2, 2]).astype(np.float32)
                    # glTF v runs top-down; flip to the framework's
                    # bottom-up convention (textures were flipped too)
                    uvs = np.stack([uv[..., 0], 1.0 - uv[..., 1]], -1)
                mesh = Mesh(
                    positions=pos, normals=nrm, faces=faces,
                    material=_material(
                        gltf, buffers, base_dir,
                        prim.get("material"), image_cache),
                    uvs=uvs,
                )
                # morph targets: per-vertex POSITION/NORMAL deltas
                # (K16/K17's morphtarget vertex path; targets without a
                # delta attribute contribute zeros)
                targets = prim.get("targets") or []
                if targets:
                    mesh.morph_positions = np.stack([
                        _accessor(gltf, buffers, t["POSITION"])
                        .astype(np.float32) if "POSITION" in t
                        else np.zeros_like(pos) for t in targets])
                    mesh.morph_normals = np.stack([
                        _accessor(gltf, buffers, t["NORMAL"])
                        .astype(np.float32) if "NORMAL" in t
                        else np.zeros_like(pos) for t in targets])
                    # node weights override mesh weights (glTF spec)
                    default_w = np.asarray(node.get(
                        "weights",
                        gltf["meshes"][node["mesh"]].get(
                            "weights", [0.0] * len(targets))), np.float32)
                    mesh.set_morph_weights(default_w)
                    asset.node_weights[node_index] = default_w
                if "skin" in node and joints is not None:
                    # skinning replaces the node transform (glTF spec):
                    # world pos = sum_j w_j (globalJoint_j @ IBM_j) @ pos
                    wsum = np.maximum(weights.sum(-1, keepdims=True), 1e-9)
                    mesh.skin_indices = joints
                    mesh.skin_weights = (weights / wsum).astype(np.float32)
                    mesh.bone_matrices = skin_data(node["skin"])
                    mesh.set_matrix(np.eye(4))
                    asset.node_skin[node_index] = node["skin"]
                else:
                    mesh.set_matrix(world)
                meshes.append(mesh)
                asset.node_meshes.setdefault(node_index, []).append(
                    len(meshes) - 1)
        for child in node.get("children", []):
            visit(child)

    scene_index = gltf.get("scene", 0)
    roots = (gltf["scenes"][scene_index]["nodes"] if gltf.get("scenes")
             else range(len(gltf.get("nodes", []))))
    for root in roots:
        visit(root)
    return asset


# ---------------------------------------------------------------------------
# Minimal GLB writer (fixture generation + round-trip tests)
# ---------------------------------------------------------------------------

def write_glb(meshes: list[Mesh], path: str):
    """Serialize meshes (positions/normals/uvs/indices + base material
    factors and PNG base-color/emissive textures) into a valid GLB."""
    from ..utils.image_io import write_png  # noqa: F401 (PNG helper nearby)
    from PIL import Image

    bin_parts: list[bytes] = []
    buffer_views, accessors, out_meshes, nodes = [], [], [], []
    materials, textures, images, samplers = [], [], [], [{}]

    def add_view(data: bytes, target=None):
        offset = sum(len(p) for p in bin_parts)
        view = {"buffer": 0, "byteOffset": offset, "byteLength": len(data)}
        if target:
            view["target"] = target
        buffer_views.append(view)
        bin_parts.append(data + b"\x00" * ((-len(data)) % 4))
        return len(buffer_views) - 1

    def add_accessor(arr: np.ndarray, gl_type: str, component: int,
                     target=None, minmax=False):
        view = add_view(np.ascontiguousarray(arr).tobytes(), target)
        acc = {
            "bufferView": view, "componentType": component,
            "count": len(arr), "type": gl_type,
        }
        if minmax:
            acc["min"] = np.asarray(arr).min(0).tolist()
            acc["max"] = np.asarray(arr).max(0).tolist()
        accessors.append(acc)
        return len(accessors) - 1

    def add_texture(img: np.ndarray | None):
        if img is None:
            return None
        # stored bottom-up internally; PNG is top-down
        arr = (np.clip(img[::-1], 0.0, 1.0) * 255).astype(np.uint8)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3 + [np.full_like(arr, 255)], -1)
        if arr.shape[-1] == 3:
            arr = np.concatenate(
                [arr, np.full_like(arr[..., :1], 255)], -1)
        buf = io.BytesIO()
        Image.fromarray(arr, "RGBA").save(buf, "PNG")
        images.append({"bufferView": add_view(buf.getvalue()),
                       "mimeType": "image/png"})
        textures.append({"source": len(images) - 1, "sampler": 0})
        return {"index": len(textures) - 1}

    def srgb(c):
        c = np.clip(np.asarray(c, np.float64), 0.0, 1.0)
        return np.where(c <= 0.0031308, c * 12.92,
                        1.055 * c ** (1 / 2.4) - 0.055)

    for i, mesh in enumerate(meshes):
        mat = mesh.material
        base_tex = add_texture(
            None if mat.map is None
            else np.concatenate(
                [srgb(mat.map[..., :3]),
                 (mat.alpha_map[..., 1:2] if mat.alpha_map is not None
                  else np.ones_like(mat.map[..., :1]))], -1))
        emis_tex = add_texture(
            None if mat.emissive_map is None else srgb(mat.emissive_map[..., :3]))
        gm = {
            "pbrMetallicRoughness": {
                "baseColorFactor": [float(x) for x in mat.diffuse],
                "roughnessFactor": float(mat.roughness),
                "metallicFactor": float(mat.metalness),
            },
            "emissiveFactor": [float(x) for x in mat.emissive],
        }
        if base_tex:
            gm["pbrMetallicRoughness"]["baseColorTexture"] = base_tex
            if mat.alpha_map is not None:
                gm["alphaMode"] = "BLEND"
        if emis_tex:
            gm["emissiveTexture"] = emis_tex
        materials.append(gm)

        attrs = {
            "POSITION": add_accessor(
                mesh.positions.astype(np.float32), "VEC3", 5126,
                target=34962, minmax=True),
            "NORMAL": add_accessor(
                mesh.normals.astype(np.float32), "VEC3", 5126, target=34962),
        }
        if mesh.uvs is not None:
            uv = np.stack(
                [mesh.uvs[..., 0], 1.0 - mesh.uvs[..., 1]], -1)
            attrs["TEXCOORD_0"] = add_accessor(
                uv.astype(np.float32), "VEC2", 5126, target=34962)
        indices = add_accessor(
            mesh.faces.astype(np.uint32).reshape(-1, 1), "SCALAR", 5125,
            target=34963)
        out_meshes.append({
            "primitives": [{
                "attributes": attrs, "indices": indices, "material": i,
            }]
        })
        nodes.append({
            "mesh": i,
            "matrix": np.asarray(mesh.matrix_world, np.float64).T.reshape(-1).tolist(),
        })

    gltf = {
        "asset": {"version": "2.0", "generator": "realism_effects_tpu"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": out_meshes,
        "materials": materials,
        "bufferViews": buffer_views,
        "accessors": accessors,
        "buffers": [{"byteLength": sum(len(p) for p in bin_parts)}],
    }
    if textures:
        gltf["textures"] = textures
        gltf["images"] = images
        gltf["samplers"] = samplers

    bin_blob = b"".join(bin_parts)
    json_blob = json.dumps(gltf, separators=(",", ":")).encode()
    json_blob += b" " * ((-len(json_blob)) % 4)
    total = 12 + 8 + len(json_blob) + 8 + len(bin_blob)
    with open(path, "wb") as f:
        f.write(struct.pack("<4sII", b"glTF", 2, total))
        f.write(struct.pack("<I4s", len(json_blob), b"JSON"))
        f.write(json_blob)
        f.write(struct.pack("<I4s", len(bin_blob), b"BIN\x00"))
        f.write(bin_blob)
