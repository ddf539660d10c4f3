"""Final GI composition (`denoiser_compose_functions.glsl`,
`DenoiserComposePass.js`): the denoised diffuse and specular GI
recombined with albedo, metalness and an accumulated-Fresnel estimate
from one GGX-VNDF sample at fixed randoms 0.25."""

from __future__ import annotations

import torch

from ..core import brdf, math3d
from ..core.framebuffers import GBuffer
from ..core.math3d import dot, mix, normalize, transform_dir_transpose, uv_grid


def denoiser_compose(diffuse_gi: torch.Tensor, specular_gi: torch.Tensor,
                     gbuffer: GBuffer, cam, scene_color=None,
                     input_type: str = "diffuse_specular", row_offset: int = 0,
                     frame_height: int | None = None) -> torch.Tensor:
    """The composed (H, W, 3) radiance; background pixels keep the
    diffuse input (the pass discards there, `DenoiserComposePass.js:56-60`).
    A row block of a larger frame passes its first row's global index
    ``row_offset`` and the frame's height (the view ray is the frame's)."""
    h, w = gbuffer.depth.shape
    depth = gbuffer.depth
    roughness = gbuffer.roughness * gbuffer.roughness  # `:56` squared
    metalness = gbuffer.metalness
    diffuse = gbuffer.diffuse[..., :3]

    view_z = math3d.depth_to_view_z(depth, cam)
    view_pos = math3d.get_view_position(uv_grid(h, w, depth.device, row_offset,
                                                frame_height), view_z,
                                        cam.projection_matrix,
                                        cam.projection_matrix_inverse)
    # world-space frame (`denoiser_compose_functions.glsl:58-70`)
    n_world = gbuffer.normal
    v_view = -normalize(view_pos)
    v_world = transform_dir_transpose(cam.view_matrix, v_view)
    t_w, b_w = brdf.onb(n_world)
    v_local = brdf.to_local(t_w, b_w, n_world, v_world)

    h_local = brdf.sample_ggx_vndf(v_local, roughness, roughness, 0.25, 0.25)
    h_local = torch.where(h_local[..., 2:3] < 0.0, -h_local, h_local)
    l_local = normalize(math3d.reflect(-v_local, h_local))
    l_world = brdf.to_world(t_w, b_w, n_world, l_local)
    l_view = normalize(transform_dir_transpose(cam.camera_matrix_world, l_world))
    view_normal = normalize(transform_dir_transpose(cam.camera_matrix_world,
                                                    n_world))
    l_view = torch.where((dot(view_normal, l_view) < 0.0)[..., None],
                         -l_view, l_view)

    h_vec = normalize(v_view + l_view)
    voh = torch.clamp(dot(v_view, h_vec), min=1e-5)
    f0 = mix(torch.full_like(diffuse, 0.04), diffuse, metalness[..., None])
    fresnel = brdf.f_schlick(f0, voh)

    if input_type == "specular" and scene_color is not None:
        diffuse_component = scene_color
    else:
        diffuse_component = (diffuse * (1.0 - metalness[..., None])
                             * (1.0 - fresnel) * diffuse_gi[..., :3])
    gi = diffuse_component + specular_gi[..., :3] * fresnel + gbuffer.emissive
    return torch.where(depth[..., None] >= 1.0, diffuse_gi[..., :3], gi)
