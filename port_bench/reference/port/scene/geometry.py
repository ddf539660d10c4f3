"""Mesh geometry primitives for demo scenes and test fixtures.

The reference leans on three.js + glTF assets for its scenes
(`example/main.js`); this package keeps a tiny self-contained geometry
kit (box / plane / uv-sphere) so tests and benchmarks need no external
assets. Numpy only: a copy of the JAX package's ``scene/geometry.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Material:
    """PBR material subset the G-buffer stores (`gbuffer_packing.glsl:3-9`).

    ``map`` / ``emissive_map`` are optional (S, S, 3|4) float textures
    multiplied onto the base colors, the subset of the 13 material-map
    properties the reference's G-buffer material carries over
    (`GBufferUtils.js:1-41`, `GBufferMaterial.js:46-96`). UV wrap is
    repeat (three.js RepeatWrapping default).

    ``alpha_map``: optional (S, S[, C]) texture whose *green* channel
    multiplies the material alpha before the stochastic coverage test,
    exactly like the reference's ``USE_ALPHAMAP`` path
    (`GBufferMaterial.js:57-61`); the first-still-frame 0.5 hard cut and
    the still-frame softening ramp (`GBufferMaterial.js:63-79`) are
    applied in the rasterizer.
    """

    diffuse: tuple = (0.8, 0.8, 0.8, 1.0)
    roughness: float = 1.0
    metalness: float = 0.0
    emissive: tuple = (0.0, 0.0, 0.0)
    map: "np.ndarray | None" = None
    emissive_map: "np.ndarray | None" = None
    alpha_map: "np.ndarray | None" = None
    #: tangent-space normal map, [0,1]-encoded RGB (three.js
    #: ``normalMap``; perturbed via screen-derivative tangent frames in
    #: the rasterizer, `normal_fragment_maps` / ``getTangentFrame``)
    normal_map: "np.ndarray | None" = None
    normal_scale: float = 1.0
    #: metallic-roughness texture (glTF layout: G = roughness,
    #: B = metalness, multiplied onto the factors — three.js
    #: ``roughnessMap``/``metalnessMap`` semantics)
    mr_map: "np.ndarray | None" = None
    #: occlusion texture (R channel; three.js ``aoMap``, glTF
    #: ``occlusionTexture`` with ``strength`` = aoMapIntensity)
    ao_map: "np.ndarray | None" = None
    ao_strength: float = 1.0

    def as_row(self) -> np.ndarray:
        return np.array(
            [*self.diffuse, self.roughness, self.metalness, *self.emissive,
             self.normal_scale, self.ao_strength],
            np.float32,
        )


#: rgba, roughness, metalness, emissive rgb, normal scale, ao strength
MATERIAL_ROW_SIZE = 11


@dataclasses.dataclass
class Mesh:
    """Triangle mesh with a model transform and its previous-frame
    transform (for per-object velocity, `VelocityDepthNormalPass.js:55-64`)."""

    positions: np.ndarray  # (V, 3) float32, object space
    normals: np.ndarray    # (V, 3) float32, object space
    faces: np.ndarray      # (F, 3) int32
    material: Material = dataclasses.field(default_factory=Material)
    matrix_world: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4))
    prev_matrix_world: np.ndarray | None = None
    #: analog of three.js visibility honored by ``getVisibleChildren``
    #: (`src/utils/SceneUtils.js:17-30`)
    visible: bool = True
    #: optional per-vertex texture coordinates (repeat-wrapped)
    uvs: np.ndarray | None = None            # (V, 2) float32
    #: optional linear-blend skinning (K17 carries previous-frame bone
    #: matrices for skinned velocity, `VelocityDepthNormalMaterial.js:8-66`)
    skin_indices: np.ndarray | None = None   # (V, 4) int32 into bone list
    skin_weights: np.ndarray | None = None   # (V, 4) float32, rows sum to 1
    bone_matrices: np.ndarray | None = None  # (B, 4, 4)
    prev_bone_matrices: np.ndarray | None = None
    #: optional morph targets: position/normal deltas blended by
    #: per-frame weights, applied before skinning — K16/K17's
    #: morphtarget/morphnormal vertex path including *previous-frame*
    #: weights for velocity (`VelocityDepthNormalMaterial.js:110-132`)
    morph_positions: np.ndarray | None = None  # (T, V, 3) position deltas
    morph_normals: np.ndarray | None = None    # (T, V, 3) normal deltas
    morph_weights: np.ndarray | None = None    # (T,) float32
    prev_morph_weights: np.ndarray | None = None
    #: exclude this mesh from SSGI tracing output — the analog of the
    #: reference's Selection camera-layers mechanism (`SSGIPass.js:71-79`,
    #: `SSGIEffect.selection`): excluded pixels return plain scene color
    gi_exclude: bool = False

    def set_morph_weights(self, weights):
        """Update morph-target weights; snapshots the previous weights for
        velocity (like the prev-frame morph influences consumed by
        `VelocityDepthNormalMaterial.js:110-132`)."""
        weights = np.asarray(weights, np.float32)
        if self.morph_weights is None:
            self.prev_morph_weights = weights.copy()
        else:
            self.prev_morph_weights = np.asarray(
                self.morph_weights, np.float32).copy()
        self.morph_weights = weights

    def set_bones(self, bones: np.ndarray):
        """Update the bone palette; snapshots the previous palette for
        velocity (like the per-mesh ``prevBoneTexture`` bookkeeping in
        `VelocityDepthNormalPass.js:24-64`)."""
        bones = np.asarray(bones, np.float64)
        if self.bone_matrices is None:
            self.prev_bone_matrices = bones.copy()
        else:
            self.prev_bone_matrices = np.asarray(self.bone_matrices).copy()
        self.bone_matrices = bones

    def set_matrix(self, m: np.ndarray):
        if self.prev_matrix_world is None:
            self.prev_matrix_world = np.asarray(m, np.float64).copy()
        else:
            self.prev_matrix_world = np.asarray(self.matrix_world, np.float64).copy()
        self.matrix_world = np.asarray(m, np.float64)

    def commit_frame(self):
        """Snapshot current transform as previous (end-of-frame bookkeeping,
        like the per-mesh ``prevVelocityMatrix`` save in
        `VelocityDepthNormalPass.js:138-146`)."""
        self.prev_matrix_world = np.asarray(self.matrix_world, np.float64).copy()
        if self.bone_matrices is not None:
            self.prev_bone_matrices = np.asarray(self.bone_matrices).copy()
        if self.morph_weights is not None:
            self.prev_morph_weights = np.asarray(
                self.morph_weights, np.float32).copy()


def scale(sx, sy=None, sz=None) -> np.ndarray:
    sy = sx if sy is None else sy
    sz = sx if sz is None else sz
    return np.diag([sx, sy, sz, 1.0])


