"""Triangle rasterizer producing the G-buffer and velocity buffers.

The reference delegates rasterization to three.js/WebGL with swapped
materials (K16 G-buffer write, `GBufferMaterial.js:46-96`; K17 velocity
write, `VelocityDepthNormalMaterial.js:105-189`). As the JAX package,
this is a **clipless 2D-homogeneous rasterizer** (Olano-Greer style):
edge functions are evaluated on homogeneous vertex coordinates, so
triangles crossing the near plane need no clipping, and the
perspective-correct interpolation weights fall out of the same edge
values. Two passes: visibility (the z-scan kernel, ``ops/raster_kernel``)
and attributes, read per pixel from a packed per-face record (the record
fetch kernel, ``ops/table_kernel``).

Entry points:
- :func:`rasterize_gbuffer`   -> :class:`GBuffer` (K16 semantics)
- :func:`rasterize_velocity`  -> :class:`VelocityBuffer` (K17 semantics:
  dual-matrix transform, per-object previous model matrices)

Stochastic alpha (a ``dither`` plane and ``cnmf``, the camera's
still-frame count) runs the z-scan's alpha variant: the material-alpha
convergence law in the scan, then, where the scene has texture pages,
depth peels that test each pass's winning texel of the alpha map and
exclude earlier winners (`GBufferMaterial.js:57-79`). All arithmetic is
written out as float32 products and sums in a fixed order, the order
XLA's CPU backend gives the JAX package's products (no matmul, so no
TF32 on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from ..core.brdf import cross
from ..core.framebuffers import GBuffer, VelocityBuffer
from ..core.math3d import fma, length
from ..ops.raster_kernel import (soft_alpha, zscan_alpha_peels, zscan_table,
                                 zscan_visibility)
from ..ops.table_kernel import LANES, face_lookup
from .scene import PackedScene

_INF = float("inf")
#: default depth-peel passes for alpha-map transparency (the JAX
#: package's ``_ALPHA_PEELS``): pixels whose first ``alpha_peels``
#: candidate layers all dither out become background
ALPHA_PEELS = 3


def _as_device(a, dev) -> torch.Tensor | None:
    """A per-frame host array (or tensor) as float32 on ``dev``."""
    if a is None:
        return None
    return tracing.to_device(np.asarray(a, np.float32) if not torch.is_tensor(a)
                             else a, dev, torch.float32, "rasterizer.as_device")


def _rotate(rot, v):
    """sum_j rot[:, i, j] * v[:, j] for i < 3, in index order: (V, 3)."""
    return rot[..., 0] * v[:, None, 0] + rot[..., 1] * v[:, None, 1] \
        + rot[..., 2] * v[:, None, 2]


def _unit(v):
    """v / max(|v|, 1e-20) over the last axis (one division)."""
    return v / torch.clamp(length(v), min=1e-20)[..., None]


def _world_transform(packed: PackedScene, model_mats: torch.Tensor,
                     bones: torch.Tensor | None = None,
                     morph_weights: torch.Tensor | None = None):
    """Object -> world positions/normals: optional morph-target blend
    (three.js order: morphs first, `VelocityDepthNormalMaterial.js:110-132`),
    optional linear-blend skinning (K17 semantics incl. bones,
    `VelocityDepthNormalMaterial.js:8-66`), then the per-mesh model matrix.
    ``morph_weights``: (M, T) per-mesh weights of the packed (V, T, 3)
    delta tables."""
    positions, normals = packed.positions, packed.normals
    vm = packed.vert_mesh_id.long()
    if morph_weights is not None and packed.num_morph_targets > 0:
        wv = morph_weights[vm][:, :, None]           # (V, T, 1)
        positions = positions + (wv * packed.morph_pos_deltas).sum(1)
        normals = normals + (wv * packed.morph_nrm_deltas).sum(1)
    if bones is not None:
        bm = bones[packed.skin_indices.long()]       # (V, 4, 4, 4)
        w = packed.skin_weights[:, :, None, None]
        skin = (bm * w).sum(1)                       # (V, 4, 4)
        positions = _rotate(skin[:, :3, :3], positions) + skin[:, :3, 3]
        normals = _rotate(skin[:, :3, :3], normals)
    mats = model_mats[vm]                            # (V, 4, 4)
    pos = _rotate(mats[:, :3, :3], positions) + mats[:, :3, 3]
    # normal matrix ~ rotation part (rigid / uniform-scale transforms)
    return pos, _unit(_rotate(mats[:, :3, :3], normals))


def _clip_positions(world_pos: torch.Tensor, view_proj) -> torch.Tensor:
    """(V, 3) world -> (V, 4) clip by the host (4, 4) matrix, summed
    pairwise as XLA's CPU dot sums [x, y, z, 1] @ M^T."""
    m = np.asarray(view_proj, np.float32)
    x, y, z = world_pos[:, 0], world_pos[:, 1], world_pos[:, 2]
    return torch.stack([(float(m[r, 0]) * x + float(m[r, 1]) * y)
                        + (float(m[r, 2]) * z + float(m[r, 3]))
                        for r in range(4)], -1)


def _homogeneous_verts(clip: torch.Tensor, height: int, width: int):
    """Clip coords -> 2D-homogeneous screen verts (hx, hy, hw):
    hx = pixel_x * w etc., linear in clip space, defined for any w."""
    w = clip[..., 3]
    hx = (0.5 * clip[..., 0] + 0.5 * w) * width
    hy = (0.5 * clip[..., 1] + 0.5 * w) * height
    return torch.stack([hx, hy, w], -1)


def _edge_coeffs(h0, h1, h2):
    """Per-triangle edge-function coefficients and determinant:
    e_i(px, py) = A_i px + B_i py + C_i, (A_i, B_i, C_i) the cross product
    of the other two homogeneous vertices."""
    def cross_coeffs(a, b):
        return (a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0])

    c0 = cross_coeffs(h1, h2)
    c1 = cross_coeffs(h2, h0)
    c2 = cross_coeffs(h0, h1)
    det = h0[..., 0] * c0[0] + h0[..., 1] * c0[1] + h0[..., 2] * c0[2]
    return (c0, c1, c2), det


def _scaled_tri_verts(clip, faces, height, width):
    """(F, 3, 3) homogeneous verts of each face scaled by 1 / (sum |w| +
    1e-6) for float32 headroom, and that scale (F, 1)."""
    tri = _homogeneous_verts(clip, height, width)[faces]
    aw = tri[..., 2].abs()
    scale = 1.0 / (aw[:, 0] + aw[:, 1] + aw[:, 2] + 1e-6)[:, None]
    return tri * scale[..., None], scale


def _visibility(clip: torch.Tensor, faces: torch.Tensor, height: int,
                width: int, face_keep: torch.Tensor | None = None,
                tri_alpha: torch.Tensor | None = None,
                dither: torch.Tensor | None = None, cnmf: float = 0.0,
                alpha_tex: tuple | None = None,
                alpha_peels: int = ALPHA_PEELS):
    """Z-buffer visibility: winning triangle id per pixel (-1 = none) and
    depth01 in [0, 1] (1 = background).

    ``tri_alpha`` (F,) / ``dither`` (H, W) / ``cnmf``: stochastic alpha
    with the reference's convergence law (`GBufferMaterial.js:57-79`):
    on the first still frame (cnmf < 0.5) a hard 0.5 cut, later a dither
    against ``mix(a, step(0.5, a), 1 / (cnmf * 0.1 + 1))``. ``alpha_tex``
    (pages (F,), uvs (V, 2), atlas (N, S, S, 4)): texel alpha (the
    nearest texel's green channel) by depth peeling: each of
    ``alpha_peels`` passes excludes the earlier passes' winners per pixel
    and tests the law on its winner's texel; a pixel whose first
    ``alpha_peels`` layers all dither out becomes background. One
    launch of the z-scan's alpha variant gives every pass's winner."""
    faces = faces.long()
    tri_h, scale = _scaled_tri_verts(clip, faces, height, width)
    tri_z = clip[faces][..., 2] * scale                # scaled z_clip
    tri_w = tri_h[..., 2]                              # scaled w
    (c0, c1, c2), det = _edge_coeffs(tri_h[:, 0], tri_h[:, 1], tri_h[:, 2])
    coeffs = torch.stack([torch.stack(c0, -1), torch.stack(c1, -1),
                          torch.stack(c2, -1)], 1)     # (F, edge, ABC)

    # degenerate-sliver protection (the JAX package's guards): cull
    # noise triangles (|det| tiny, or below 2e-6 |w0 w1 w2|), and clamp
    # coverage to the projected bbox (+1 px) when all verts are in front
    # of the camera; triangles crossing w = 0 keep an unbounded bbox
    wprod = tri_w[:, 0] * tri_w[:, 1] * tri_w[:, 2]
    valid = (det.abs() > 1e-14) & (det.abs() > 2e-6 * wprod.abs())
    if face_keep is not None:
        valid &= face_keep
    w_safe = torch.where(tri_w.abs() > 1e-20, tri_w, 1e-20)
    px_v = tri_h[..., 0] / w_safe                      # (F, 3)
    py_v = tri_h[..., 1] / w_safe
    w_pos = (tri_w > 1e-12).all(1)
    tri_bbox = torch.stack([
        torch.where(w_pos, px_v.amin(1) - 1.0, -_INF),
        torch.where(w_pos, px_v.amax(1) + 1.0, _INF),
        torch.where(w_pos, py_v.amin(1) - 1.0, -_INF),
        torch.where(w_pos, py_v.amax(1) + 1.0, _INF),
    ], -1)
    sgn = torch.where(det >= 0.0, 1.0, -1.0)
    depth01 = lambda i, z: torch.where(i >= 0, z * 0.5 + 0.5, 1.0)
    if tri_alpha is None:
        ids, zbuf = zscan_visibility(coeffs, tri_z, tri_w, sgn, valid,
                                     tri_bbox, height, width)
        return ids, depth01(ids, zbuf)

    # every pass in one z-scan: plane p is pass p's raw winner
    tab = zscan_table(coeffs, tri_z, tri_w, sgn, valid, tri_bbox)
    passes = max(alpha_peels, 1) if alpha_tex is not None else 1
    ids_p, z_p = zscan_alpha_peels(tab, height, width, tri_alpha, dither, cnmf,
                                   passes)
    if alpha_tex is None:
        return ids_p[0], depth01(ids_p[0], z_p[0])

    # --- texel-alpha depth peeling
    winner_keeps = _texel_law(clip, faces, height, width, alpha_tex, tri_alpha,
                              dither, cnmf)
    keep = winner_keeps(ids_p[0])
    final_ids = torch.where(keep, ids_p[0], -1)
    final_z = torch.where(keep, z_p[0], _INF)
    resolved = keep
    for p in range(1, passes):
        kp = winner_keeps(ids_p[p])
        take = ~resolved & kp
        final_ids = torch.where(take, ids_p[p], final_ids)
        final_z = torch.where(take, z_p[p], final_z)
        resolved = resolved | kp
    return final_ids, depth01(final_ids, final_z)


def _texel_law(clip, faces, height, width, alpha_tex, tri_alpha, dither, cnmf):
    """``winner_keeps(win_ids)`` of the depth peels: (H, W) bool, the law
    on each pixel's winning texel, material alpha times the nearest
    texel's *green* channel (`GBufferMaterial.js:60`), and True where no
    triangle won. ``alpha_tex`` (pages (F,), uvs (V, 2), atlas
    (N, S, S, 4)) as :func:`_visibility`'s."""
    pages, uvs, atlas = alpha_tex
    size = atlas.shape[1]
    table = _pack_face_table([
        _face_edge_coeffs(clip, faces, height, width),   # 0..8
        uvs[faces].reshape(-1, 6),                       # 9..14
        pages.float(),                                   # 15
        tri_alpha,                                       # 16
    ])

    def winner_keeps(win_ids):
        rec = _fetch_face_table(table, win_ids)
        wts = _weights_from_coeffs(rec[..., 0:9], height, width)
        uvv = rec[..., 9:15]
        uv = (uvv[..., 0:2] * wts[..., 0:1] + uvv[..., 2:4] * wts[..., 1:2]
              + uvv[..., 4:6] * wts[..., 2:3])
        page = rec[..., 15].to(torch.int32)
        iu = (torch.remainder(uv[..., 0], 1.0) * size).to(torch.int32) % size
        iv = (torch.remainder(uv[..., 1], 1.0) * size).to(torch.int32) % size
        tex_a = atlas[torch.clamp(page, min=0).long(), iv.long(), iu.long(), 1]
        a = rec[..., 16] * torch.where(page >= 0, tex_a, 1.0)
        keep_all, a_soft, hard = soft_alpha(a, cnmf)
        keep = keep_all if hard else keep_all | (dither < a_soft)
        return keep | (win_ids < 0)   # background resolves trivially

    return winner_keeps


# --- per-face packed records ------------------------------------------------
#
# Every per-pixel quantity of the attribute pass (edge weights, composed
# attribute planes, the material row) is a per-FACE constant: one packed
# record per face, fetched once per pixel by its winning face id, replaces
# the chain face -> vertices -> attributes -> material. Same values as
# the per-pixel chain: the same float32 operations, hoisted per face.

def _face_edge_coeffs(clip: torch.Tensor, faces: torch.Tensor,
                      height: int, width: int) -> torch.Tensor:
    """(F, 9): the scaled edge-function coefficients per face
    (c0 | c1 | c2)."""
    tri, _ = _scaled_tri_verts(clip, faces.long(), height, width)
    cs, _ = _edge_coeffs(tri[:, 0], tri[:, 1], tri[:, 2])
    return torch.cat([torch.stack(c, -1) for c in cs], -1)


def _face_attr_coeffs(edge9: torch.Tensor, attr: torch.Tensor) -> torch.Tensor:
    """The screen-space numerator plane sum_i e_i(px, py) a_i of
    perspective-correct interpolation, per face and channel.

    edge9: (F, 9); attr: (F, 3, C). Returns (F, 3 C): [A, B, C] per
    channel."""
    e = edge9.reshape(-1, 3, 3)                        # (F, vertex, ABC)
    # (F, C, ABC), the FMA chain of the JAX package's einsum on the CPU
    out = e[:, 0, None, :] * attr[:, 0, :, None]
    out = fma(e[:, 1, None, :], attr[:, 1, :, None], out)
    out = fma(e[:, 2, None, :], attr[:, 2, :, None], out)
    return out.reshape(attr.shape[0], -1)


def _face_denominator(edge9: torch.Tensor) -> torch.Tensor:
    """(F, 3): coefficients of sum_i e_i (the weight normaliser)."""
    e = edge9.reshape(-1, 3, 3)
    return e[:, 0] + e[:, 1] + e[:, 2]


def _eval_planes(rec: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Evaluate packed [A, B, C] * C linear planes at pixel centres:
    rec (H, W, 3 C) -> (H, W, C)."""
    px = torch.arange(width, dtype=torch.float32, device=rec.device)[None, :, None] + 0.5
    py = torch.arange(height, dtype=torch.float32, device=rec.device)[:, None, None] + 0.5
    r = rec.reshape(rec.shape[:-1] + (rec.shape[-1] // 3, 3))
    return r[..., 0] * px + r[..., 1] * py + r[..., 2]


def _pack_face_table(cols) -> torch.Tensor:
    """Pack per-face columns ((F,) or (F, C)) into one (rows, 128, K)
    float32 record table, zero-padded to whole rows of 128 faces."""
    rec = torch.cat([(c[:, None] if c.ndim == 1 else c).float() for c in cols], -1)
    f, k = rec.shape
    rows = -(-f // LANES)
    rec = torch.nn.functional.pad(rec, (0, 0, 0, rows * LANES - f))
    return rec.reshape(rows, LANES, k).contiguous()


def _fetch_face_table(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(H, W) face ids -> (H, W, K) packed record."""
    return face_lookup(table, ids)


def _weights_from_coeffs(coeffs: torch.Tensor, height: int, width: int):
    """Per-pixel perspective-correct weights (H, W, 3) from the fetched
    (H, W, 9) edge-coefficient record: e_i / sum(e)."""
    dev = coeffs.device
    px = torch.arange(width, dtype=torch.float32, device=dev)[None, :] + 0.5
    py = torch.arange(height, dtype=torch.float32, device=dev)[:, None] + 0.5
    e = torch.stack([coeffs[..., 3 * i] * px + coeffs[..., 3 * i + 1] * py
                     + coeffs[..., 3 * i + 2] for i in range(3)], -1)
    se = e[..., 0:1] + e[..., 1:2] + e[..., 2:3]
    return e / torch.where(se.abs() > 1e-20, se, 1e-20)


def _sample_atlas(atlas: torch.Tensor, page: torch.Tensor, uv: torch.Tensor):
    """Bilinear repeat-wrapped fetch from (N, S, S, C) at per-pixel page."""
    s = atlas.shape[1]
    x = torch.remainder(uv[..., 0], 1.0) * s - 0.5
    y = torch.remainder(uv[..., 1], 1.0) * s - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    pg = page.long()

    def tap(yy, xx):
        yy = torch.remainder(yy.to(torch.int32), s).long()
        xx = torch.remainder(xx.to(torch.int32), s).long()
        return atlas[pg, yy, xx]

    c00 = tap(y0, x0)
    c01 = tap(y0, x0 + 1)
    c10 = tap(y0 + 1, x0)
    c11 = tap(y0 + 1, x0 + 1)
    top = c00 + (c01 - c00) * fx
    bot = c10 + (c11 - c10) * fx
    return top + (bot - top) * fy


def _dfdx(p: torch.Tensor) -> torch.Tensor:
    """Screen-space x derivative of an (H, W, C) plane (forward diff,
    edge-clamped; the dFdx analog)."""
    d = p[:, 1:] - p[:, :-1]
    return torch.cat([d, d[:, -1:]], 1)


def _dfdy(p: torch.Tensor) -> torch.Tensor:
    d = p[1:] - p[:-1]
    return torch.cat([d, d[-1:]], 0)


def _perturb_normal(n, world_pos, uv, map_rgb, scale):
    """Tangent-space normal map with screen-derivative tangent frames
    (three.js ``getTangentFrame`` + ``normal_fragment_maps``,
    `normal_pars_fragment.glsl.js`). Returns unit normals (H, W, 3)."""
    q0 = _dfdx(world_pos)
    q1 = _dfdy(world_pos)
    st0 = _dfdx(uv)
    st1 = _dfdy(uv)
    q1perp = cross(q1, n)
    q0perp = cross(n, q0)
    t = q1perp * st0[..., 0:1] + q0perp * st1[..., 0:1]
    b = q1perp * st0[..., 1:2] + q0perp * st1[..., 1:2]
    sq = lambda v: v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]
    det = torch.maximum(sq(t), sq(b))
    inv = torch.where(det > 0.0,
                      1.0 / torch.sqrt(torch.clamp(det, min=1e-30)), 0.0)[..., None]
    mapn = map_rgb * 2.0 - 1.0
    s = scale[..., None] if scale.ndim == 2 else scale
    out = (t * inv * (mapn[..., 0:1] * s) + b * inv * (mapn[..., 1:2] * s)
           + n * mapn[..., 2:3])
    norm = length(out)[..., None]
    # degenerate frames (no uv variation) keep the geometric normal
    return torch.where(norm > 1e-8, out / torch.clamp(norm, min=1e-20), n)


def _alpha_inputs(packed: PackedScene, dither):
    """(tri_alpha, alpha_tex) for stochastic transparency, or Nones
    without a ``dither``. The texel peels run wherever the scene has
    texture pages (an alpha map or not), as in the JAX package."""
    if dither is None:
        return None, None
    face_mesh = packed.face_mesh
    tri_alpha = packed.materials[face_mesh, 3].contiguous()
    alpha_tex = None
    if packed.map_atlas.shape[0] > 0:
        alpha_tex = (packed.alpha_map_index[face_mesh], packed.uvs,
                     packed.map_atlas)
    return tri_alpha, alpha_tex


def rasterize_gbuffer(packed: PackedScene, model_mats, view_proj,
                      height: int, width: int, bones=None, dither=None,
                      cnmf: float = 0.0, morph_weights=None,
                      alpha_peels: int = ALPHA_PEELS,
                      face_keep: torch.Tensor | None = None,
                      return_ids: bool = False):
    """Render the G-buffer (K16 semantics: optional morph targets,
    skinning, and stochastic-alpha transparency by ``dither`` (H, W)
    noise on the scene's device and ``cnmf`` = cameraNotMovedFrames for
    the convergence law; ``alpha_peels`` bounds alpha-map depth, each
    peel one more plane of the z-scan). ``model_mats`` (M, 4, 4),
    ``bones`` (B, 4, 4) and ``morph_weights`` (M, T) are host arrays or
    tensors (copied to the scene's device); ``view_proj`` is a host
    (4, 4) float32 matrix. ``face_keep`` (F,) bool drops faces from the
    render entirely (the camera-layer re-render of exact SSGI Selection,
    `SSGIPass.js:71-79`). ``return_ids``: also return the (H, W) int32
    winner-face ids, to share the visibility scan with
    :func:`rasterize_velocity`. Without a ``dither`` every surface is
    opaque."""
    dev = packed.device
    world_pos, world_nrm = _world_transform(
        packed, _as_device(model_mats, dev), _as_device(bones, dev),
        _as_device(morph_weights, dev))
    clip = _clip_positions(world_pos, view_proj)
    tri_alpha, alpha_tex = _alpha_inputs(packed, dither)
    ids, depth01 = _visibility(clip, packed.faces, height, width, face_keep,
                               tri_alpha, dither, float(cnmf), alpha_tex,
                               alpha_peels)
    valid = ids >= 0
    faces = packed.faces.long()
    textured = packed.map_atlas.shape[0] > 0
    face_mesh = packed.face_mesh
    n_mat = packed.materials.shape[1]
    edge9 = _face_edge_coeffs(clip, faces, height, width)
    cols = [
        _face_attr_coeffs(edge9, world_nrm[faces]),      # 0..8
        _face_denominator(edge9),                        # 9..11
        face_mesh.float(),                               # 12
        packed.materials[face_mesh],                     # 13..13+n_mat
    ]
    if textured:
        cols.append(_face_attr_coeffs(edge9, packed.uvs[faces]))
        cols.append(_face_attr_coeffs(edge9, world_pos[faces]))
        # per-mesh atlas page indices ride the record (small ints, exact
        # through float32)
        cols.append(torch.stack([
            packed.map_index[face_mesh], packed.emissive_map_index[face_mesh],
            packed.mr_map_index[face_mesh], packed.normal_map_index[face_mesh],
            packed.ao_map_index[face_mesh]], -1).float())
    rec = _fetch_face_table(_pack_face_table(cols), ids)
    den = _eval_planes(rec[..., 9:12], height, width)[..., 0]
    inv_den = 1.0 / torch.where(den.abs() > 1e-20, den, 1e-20)
    nrm = _unit(_eval_planes(rec[..., 0:9], height, width) * inv_den[..., None])

    mesh_id = rec[..., 12].to(torch.int32)
    mat = rec[..., 13:13 + n_mat]          # (H, W, MATERIAL_ROW_SIZE)
    diffuse = mat[..., 0:4]
    emissive = mat[..., 6:9]
    roughness = mat[..., 4]
    metalness = mat[..., 5]
    ao = None
    if textured:
        # perspective-correct uv, repeat wrap, atlas page per mesh
        # (`GBufferMaterial.js:46-96` map sampling)
        base = 13 + n_mat
        uv = _eval_planes(rec[..., base: base + 6], height, width) * inv_den[..., None]
        pages = rec[..., base + 15: base + 20].to(torch.int32)
        m_page, e_page, mr_page, n_page, a_page = pages.unbind(-1)
        atlas = packed.map_atlas
        page_of = lambda p: torch.clamp(p, min=0)
        tex = _sample_atlas(atlas, page_of(m_page), uv)
        diffuse = torch.where((m_page >= 0)[..., None], diffuse * tex, diffuse)
        etex = _sample_atlas(atlas, page_of(e_page), uv)
        emissive = torch.where((e_page >= 0)[..., None], emissive * etex[..., :3],
                               emissive)
        # metallic-roughness texture (glTF: G = roughness, B = metalness)
        mr_tex = _sample_atlas(atlas, page_of(mr_page), uv)
        has_mr = mr_page >= 0
        roughness = torch.where(has_mr, roughness * mr_tex[..., 1], roughness)
        metalness = torch.where(has_mr, metalness * mr_tex[..., 2], metalness)
        n_tex = _sample_atlas(atlas, page_of(n_page), uv)
        wpos = _eval_planes(rec[..., base + 6: base + 15], height, width) \
            * inv_den[..., None]
        nrm = torch.where((n_page >= 0)[..., None],
                          _perturb_normal(nrm, wpos, uv, n_tex[..., :3], mat[..., 9]),
                          nrm)
        # occlusion texture -> baked-AO plane (three.js aomap_fragment)
        a_tex = _sample_atlas(atlas, page_of(a_page), uv)
        ao = torch.where(a_page >= 0, 1.0 + mat[..., 10] * (a_tex[..., 0] - 1.0), 1.0)

    vmask = valid[..., None]
    gb = GBuffer(
        diffuse=torch.where(vmask, diffuse, 0.0),
        normal=torch.where(vmask, nrm, 0.0),
        roughness=torch.where(valid, roughness, 1.0),
        metalness=torch.where(valid, metalness, 0.0),
        emissive=torch.where(vmask, emissive, 0.0),
        depth=depth01,
        mesh_id=torch.where(valid, mesh_id, -1).to(torch.int32),
        ao=None if ao is None else torch.where(valid, ao, 1.0),
    )
    return (gb, ids) if return_ids else gb


def rasterize_velocity(packed: PackedScene, model_mats, prev_model_mats,
                       view_proj, prev_view_proj, height: int, width: int,
                       bones=None, prev_bones=None, dither=None,
                       cnmf: float = 0.0, morph_weights=None,
                       prev_morph_weights=None,
                       alpha_peels: int = ALPHA_PEELS,
                       share_ids: torch.Tensor | None = None) -> VelocityBuffer:
    """Render velocity/depth/normal (K17 semantics). Both view-proj
    matrices must be UNJITTERED (`VelocityDepthNormalPass.js:166-171`).
    Velocity is the uv displacement current - previous
    (`VelocityDepthNormalMaterial.js:75-84`); skinned and morphed meshes
    use the previous frame's bones and weights for the previous position.

    ``share_ids``: (H, W) winner ids of an already-run visibility scan
    (the G-buffer's); depth then comes from the winner's unjittered clip
    planes. None runs this pass's own scan, with the stochastic alpha of
    ``dither``, ``cnmf`` and ``alpha_peels`` as :func:`rasterize_gbuffer`."""
    dev = packed.device
    world_pos, world_nrm = _world_transform(
        packed, _as_device(model_mats, dev), _as_device(bones, dev),
        _as_device(morph_weights, dev))
    prev_world_pos, _ = _world_transform(
        packed, _as_device(prev_model_mats, dev),
        _as_device(prev_bones, dev) if bones is not None else None,
        _as_device(prev_morph_weights, dev) if morph_weights is not None else None)
    clip = _clip_positions(world_pos, view_proj)
    prev_clip = _clip_positions(prev_world_pos, prev_view_proj)

    if share_ids is None:
        tri_alpha, alpha_tex = _alpha_inputs(packed, dither)
        ids, depth01 = _visibility(clip, packed.faces, height, width, None,
                                   tri_alpha, dither, float(cnmf), alpha_tex,
                                   alpha_peels)
    else:
        ids, depth01 = share_ids, None
    valid = ids >= 0
    faces = packed.faces.long()
    edge9 = _face_edge_coeffs(clip, faces, height, width)
    xyw = lambda c: c[faces][..., tracing.to_device([0, 1, 3], dev, torch.int64,
                                                    "rasterizer.xyw_index")]
    cols = [
        _face_attr_coeffs(edge9, xyw(clip)),                # 0..8
        _face_attr_coeffs(edge9, xyw(prev_clip)),           # 9..17
        _face_attr_coeffs(edge9, world_nrm[faces]),         # 18..26
        _face_denominator(edge9),                           # 27..29
    ]
    if share_ids is not None:
        cols.append(_face_attr_coeffs(edge9, clip[faces][..., 2:3]))  # 30..32
    rec = _fetch_face_table(_pack_face_table(cols), ids)
    cur = _eval_planes(rec[..., 0:9], height, width)        # (H, W, 3): x y w
    prev = _eval_planes(rec[..., 9:18], height, width)
    safe = lambda w: torch.where(w.abs() > 1e-6, w, 1e-6)
    cur_ndc = cur[..., :2] / safe(cur[..., 2:3])
    prev_ndc = prev[..., :2] / safe(prev[..., 2:3])
    vel = (cur_ndc - prev_ndc) * 0.5       # ndc -> uv units

    den = _eval_planes(rec[..., 27:30], height, width)[..., 0]
    nrm = _unit(_eval_planes(rec[..., 18:27], height, width)
                / torch.where(den.abs() > 1e-20, den, 1e-20)[..., None])

    if depth01 is None:
        # z_ndc = (sum e z) / (sum e w) of the winner under the UNJITTERED
        # matrices, the interpolation the scan evaluates
        zc = _eval_planes(rec[..., 30:33], height, width)[..., 0]
        depth01 = torch.where(valid, zc / safe(cur[..., 2]) * 0.5 + 0.5, 1.0)

    vmask = valid[..., None]
    return VelocityBuffer(
        velocity=torch.where(vmask, vel, 0.0),
        normal=torch.where(vmask, nrm, 0.0),
        depth=depth01,
    )
