"""Scene container + packing into device tensors.

Boundary of the system (SURVEY.md §7): the reference re-renders the
user's three.js scene to produce its G-buffer and velocity buffers
(`src/gbuffer/GBufferPass.js:100-119`,
`src/temporal-reproject/pass/VelocityDepthNormalPass.js:165-193`); here
a :class:`Scene` of meshes is packed once into flat tensors on the
device (static topology), while the per-mesh model matrices, bone
palettes and morph weights stay per-frame host arrays that the composer
copies to the device each frame (a few KB).

``Scene.pack`` builds the same numpy arrays as the JAX package's
(``pack_arrays``) and moves them to the device once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .geometry import Material, Mesh

_PACKED_DTYPES = {
    "positions": torch.float32, "normals": torch.float32,
    "faces": torch.int32, "vert_mesh_id": torch.int32,
    "materials": torch.float32, "skin_indices": torch.int32,
    "skin_weights": torch.float32, "uvs": torch.float32,
    "map_atlas": torch.float32, "map_index": torch.int32,
    "emissive_map_index": torch.int32, "alpha_map_index": torch.int32,
    "normal_map_index": torch.int32, "mr_map_index": torch.int32,
    "ao_map_index": torch.int32, "morph_pos_deltas": torch.float32,
    "morph_nrm_deltas": torch.float32,
}


@dataclasses.dataclass(frozen=True)
class PackedScene:
    """Static scene tensors on one device; packed once, reused per frame."""

    positions: torch.Tensor   # (V, 3)
    normals: torch.Tensor     # (V, 3)
    faces: torch.Tensor       # (F, 3) int32
    vert_mesh_id: torch.Tensor  # (V,) int32
    materials: torch.Tensor   # (M, MATERIAL_ROW_SIZE)
    skin_indices: torch.Tensor  # (V, 4) int32 into the global bone table
    skin_weights: torch.Tensor  # (V, 4) float32
    uvs: torch.Tensor           # (V, 2) float32 texture coordinates
    map_atlas: torch.Tensor     # (N, S, S, 4) material textures (N may be 0)
    map_index: torch.Tensor     # (M,) int32 page into map_atlas, -1 = none
    emissive_map_index: torch.Tensor  # (M,) int32, -1 = none
    alpha_map_index: torch.Tensor     # (M,) int32, -1 = none
    normal_map_index: torch.Tensor    # (M,) int32, -1 = none
    mr_map_index: torch.Tensor        # (M,) int32, -1 = none
    ao_map_index: torch.Tensor        # (M,) int32, -1 = none
    morph_pos_deltas: torch.Tensor    # (V, T, 3) position deltas (T may be 0)
    morph_nrm_deltas: torch.Tensor    # (V, T, 3) normal deltas
    #: a material alpha below 1 or an alpha map (host flag, set at packing)
    has_alpha: bool = False

    @classmethod
    def from_arrays(cls, arrays: dict, device) -> "PackedScene":
        """Tensors on ``device`` from a dict of the fields' arrays (numpy,
        or anything ``np.asarray`` takes)."""
        arrays = {k: np.array(arrays[k]) for k in _PACKED_DTYPES}
        has_alpha = bool((arrays["materials"][:, 3] < 1.0).any()
                         or (arrays["alpha_map_index"] >= 0).any())
        return cls(**{
            k: torch.as_tensor(arrays[k], dtype=dt, device=device)
            for k, dt in _PACKED_DTYPES.items()}, has_alpha=has_alpha)

    @property
    def device(self) -> torch.device:
        return self.positions.device

    @property
    def num_morph_targets(self) -> int:
        return int(self.morph_pos_deltas.shape[1])

    @property
    def num_faces(self) -> int:
        return int(self.faces.shape[0])

    @property
    def face_mesh(self) -> torch.Tensor:
        """(F,) int64 mesh index of each face."""
        return self.vert_mesh_id[self.faces[:, 0].long()].long()


def _resize_texture(tex: np.ndarray, size: int) -> np.ndarray:
    """Nearest-neighbor resize to (size, size, 4) float32 (alpha=1 pad)."""
    tex = np.asarray(tex, np.float32)
    if tex.ndim == 2:
        tex = tex[..., None].repeat(3, -1)
    if tex.shape[2] == 3:
        tex = np.concatenate([tex, np.ones_like(tex[..., :1])], -1)
    h, w = tex.shape[:2]
    ys = np.minimum((np.arange(size) * h) // size, h - 1)
    xs = np.minimum((np.arange(size) * w) // size, w - 1)
    return tex[ys][:, xs]


#: all material maps resample to this square atlas page size
TEXTURE_ATLAS_SIZE = 256


class Scene:
    def __init__(self, background_color=(0.0, 0.0, 0.0)):
        self.meshes: list[Mesh] = []
        self.background_color = np.asarray(background_color, np.float32)
        #: EquirectEnv or a raw (H, W, 3) equirect map, optional
        self.environment = None
        # directional "sun" for the built-in direct-light shader
        self.sun_direction = np.array([0.5, 0.8, 0.3], np.float32)
        self.sun_color = np.array([1.0, 0.96, 0.9], np.float32)
        self.sun_intensity = 2.5
        self.ambient = np.array([0.25, 0.28, 0.33], np.float32)
        #: GGX specular sun response strength (0 disables — the default
        #: keeps the Lambert-only look the golden fixtures pin; set 1.0
        #: for the three.js MeshPhysicalMaterial-style highlight)
        self.sun_specular = 0.0
        #: three.js PointLight analogs for the built-in shader
        #: (`add_point_light`); list of dicts, packed by lighting_params
        self.point_lights: list[dict] = []

    def add_point_light(self, position, color=(1.0, 1.0, 1.0),
                        intensity=1.0, distance=0.0, decay=2.0):
        """three.js ``PointLight(color, intensity, distance, decay)``
        analog for the built-in direct-light shader: physical inverse-
        square falloff with the same windowed cutoff three.js applies
        when ``distance > 0`` (``getDistanceAttenuation``:
        ``pow(clamp(1 - (d/distance)^4, 0, 1), 2) / d^decay``)."""
        self.point_lights.append({
            "position": np.asarray(position, np.float32),
            "color": np.asarray(color, np.float32),
            "intensity": float(intensity),
            "distance": float(distance),
            "decay": float(decay),
        })
        return self.point_lights[-1]

    def add(self, mesh: Mesh) -> Mesh:
        self.meshes.append(mesh)
        return mesh

    def visible_meshes(self) -> list:
        """``getVisibleChildren`` analog (`SceneUtils.js:17-30`)."""
        return [m for m in self.meshes if m.visible]

    def max_morph_targets(self) -> int:
        """Max morph-target count over all meshes (packed T dimension)."""
        return max(
            (m.morph_positions.shape[0] for m in self.meshes
             if m.morph_positions is not None),
            default=0,
        )

    def pack(self, device=None) -> PackedScene:
        """The packed scene on ``device`` (``cuda`` unless asked for
        another)."""
        from ..composer import resolve_device

        return PackedScene.from_arrays(self.pack_arrays(),
                                       resolve_device(device))

    def pack_arrays(self) -> dict:
        """The packed scene as numpy arrays, keyed by ``PackedScene``'s
        fields; the same arrays as the JAX package's ``Scene.pack``."""
        positions, normals, faces, vert_ids, mats = [], [], [], [], []
        skin_idx, skin_wgt, uvs = [], [], []
        atlas_pages, map_idx, emis_idx, alpha_idx = [], [], [], []
        normal_idx, mr_idx, ao_idx = [], [], []
        morph_pos, morph_nrm = [], []
        t_max = self.max_morph_targets()
        offset = 0
        bone_offset = 1  # global bone 0 is the identity for unskinned verts

        def page_for(tex):
            if tex is None:
                return -1
            atlas_pages.append(_resize_texture(tex, TEXTURE_ATLAS_SIZE))
            return len(atlas_pages) - 1

        def morph_rows(mesh, nv):
            """(V, T_max, 3) zero-padded per-vertex morph deltas."""
            pos = np.zeros((nv, t_max, 3), np.float32)
            nrm = np.zeros((nv, t_max, 3), np.float32)
            if mesh.morph_positions is not None:
                t = mesh.morph_positions.shape[0]
                pos[:, :t] = np.transpose(
                    np.asarray(mesh.morph_positions, np.float32), (1, 0, 2))
                if mesh.morph_normals is not None:
                    nrm[:, :t] = np.transpose(
                        np.asarray(mesh.morph_normals, np.float32), (1, 0, 2))
            return pos, nrm

        for i, mesh in enumerate(self.meshes):
            map_idx.append(page_for(mesh.material.map))
            emis_idx.append(page_for(mesh.material.emissive_map))
            alpha_idx.append(page_for(mesh.material.alpha_map))
            normal_idx.append(page_for(mesh.material.normal_map))
            mr_idx.append(page_for(mesh.material.mr_map))
            ao_idx.append(page_for(mesh.material.ao_map))
            if not mesh.visible:
                # keep the mesh slot (matrices stay index-aligned) but
                # contribute no geometry
                mats.append(mesh.material.as_row())
                if mesh.bone_matrices is not None:
                    bone_offset += len(mesh.bone_matrices)
                continue
            nv = len(mesh.positions)
            positions.append(mesh.positions)
            normals.append(mesh.normals)
            faces.append(mesh.faces + offset)
            vert_ids.append(np.full(nv, i, np.int32))
            mats.append(mesh.material.as_row())
            uvs.append(
                mesh.uvs.astype(np.float32) if mesh.uvs is not None
                else np.zeros((nv, 2), np.float32)
            )
            if mesh.skin_indices is not None:
                skin_idx.append(mesh.skin_indices.astype(np.int32) + bone_offset)
                skin_wgt.append(mesh.skin_weights.astype(np.float32))
            else:
                skin_idx.append(np.zeros((nv, 4), np.int32))
                w = np.zeros((nv, 4), np.float32)
                w[:, 0] = 1.0
                skin_wgt.append(w)
            if t_max > 0:
                mp, mn = morph_rows(mesh, nv)
                morph_pos.append(mp)
                morph_nrm.append(mn)
            if mesh.bone_matrices is not None:
                bone_offset += len(mesh.bone_matrices)
            offset += nv
        if not positions:  # empty / fully-hidden scene: one degenerate tri
            positions = [np.zeros((1, 3), np.float32)]
            normals = [np.array([[0, 1, 0]], np.float32)]
            faces = [np.zeros((1, 3), np.int32)]  # zero-area: never covers
            vert_ids = [np.zeros(1, np.int32)]
            uvs = [np.zeros((1, 2), np.float32)]
            skin_idx = [np.zeros((1, 4), np.int32)]
            w0 = np.zeros((1, 4), np.float32)
            w0[:, 0] = 1.0
            skin_wgt = [w0]
            if t_max > 0:
                morph_pos = [np.zeros((1, t_max, 3), np.float32)]
                morph_nrm = [np.zeros((1, t_max, 3), np.float32)]
            if not mats:
                mats = [Material().as_row()]
        n_verts = sum(len(p) for p in positions)
        i32 = lambda a: np.asarray(a, np.int32)
        return {
            "positions": np.concatenate(positions).astype(np.float32),
            "normals": np.concatenate(normals).astype(np.float32),
            "faces": np.concatenate(faces).astype(np.int32),
            "vert_mesh_id": np.concatenate(vert_ids).astype(np.int32),
            "materials": np.stack(mats).astype(np.float32),
            "skin_indices": np.concatenate(skin_idx).astype(np.int32),
            "skin_weights": np.concatenate(skin_wgt).astype(np.float32),
            "uvs": np.concatenate(uvs).astype(np.float32),
            "map_atlas": (
                np.stack(atlas_pages) if atlas_pages
                else np.zeros((0, TEXTURE_ATLAS_SIZE, TEXTURE_ATLAS_SIZE, 4),
                              np.float32)),
            "map_index": i32(map_idx),
            "emissive_map_index": i32(emis_idx),
            "alpha_map_index": i32(alpha_idx),
            "normal_map_index": i32(normal_idx),
            "mr_map_index": i32(mr_idx),
            "ao_map_index": i32(ao_idx),
            "morph_pos_deltas": (
                np.concatenate(morph_pos) if morph_pos
                else np.zeros((n_verts, 0, 3), np.float32)),
            "morph_nrm_deltas": (
                np.concatenate(morph_nrm) if morph_nrm
                else np.zeros((n_verts, 0, 3), np.float32)),
        }

    # --- bone palettes (identity bone 0 + per-mesh palettes) ------------
    def num_bones(self) -> int:
        return 1 + sum(
            len(m.bone_matrices) for m in self.meshes if m.bone_matrices is not None
        )

    def bone_matrices(self, prev: bool = False) -> np.ndarray:
        mats = [np.eye(4)]
        for m in self.meshes:
            if m.bone_matrices is None:
                continue
            src = m.prev_bone_matrices if prev else m.bone_matrices
            if src is None:
                src = m.bone_matrices
            mats.extend(np.asarray(src))
        return np.stack(mats).astype(np.float32)

    # --- morph-target weights (per-mesh rows, zero-padded to T_max) ------
    def morph_weight_matrix(self, prev: bool = False) -> np.ndarray:
        t_max = self.max_morph_targets()
        out = np.zeros((max(len(self.meshes), 1), t_max), np.float32)
        for i, m in enumerate(self.meshes):
            w = m.prev_morph_weights if prev else m.morph_weights
            if w is None:
                w = m.morph_weights
            if w is not None:
                w = np.asarray(w, np.float32)
                out[i, : w.shape[0]] = w
        return out

    def gi_mask(self) -> np.ndarray:
        """Per-mesh SSGI participation (1 = traced, 0 = excluded); the
        Selection-layers analog (`SSGIPass.js:71-79`)."""
        return np.asarray(
            [0.0 if m.gi_exclude else 1.0 for m in self.meshes] or [1.0],
            np.float32,
        )

    def model_matrices(self) -> np.ndarray:
        """(M, 4, 4) float32 host array of the meshes' world matrices."""
        return np.stack([m.matrix_world for m in self.meshes]).astype(np.float32)

    def prev_model_matrices(self) -> np.ndarray:
        return np.stack([
            m.prev_matrix_world if m.prev_matrix_world is not None
            else m.matrix_world
            for m in self.meshes
        ]).astype(np.float32)

    def commit_frame(self):
        for m in self.meshes:
            m.commit_frame()

    def lighting_params(self, device=None) -> dict:
        """The direct-light shader's parameters as float32 tensors on
        ``device`` (``cuda`` unless asked for another). Key presence is
        static: ``sun_specular`` only when it is > 0, ``point_*`` only
        with point lights."""
        from ..composer import resolve_device

        dev = resolve_device(device)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        sun = self.sun_direction / np.linalg.norm(self.sun_direction)
        params = {
            "sun_direction": t(sun),
            "sun_color": t(self.sun_color * self.sun_intensity),
            "ambient": t(self.ambient),
            "background_color": t(self.background_color),
        }
        if self.sun_specular > 0.0:
            params["sun_specular"] = t(self.sun_specular)
        if self.point_lights:
            lights = self.point_lights
            params["point_positions"] = t(np.stack([p["position"] for p in lights]))
            params["point_colors"] = t(np.stack([p["color"] * p["intensity"]
                                                 for p in lights]))
            params["point_distance"] = t([p["distance"] for p in lights])
            params["point_decay"] = t([p["decay"] for p in lights])
        return params
