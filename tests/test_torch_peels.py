"""The z-scan's alpha variant with every peel in one call, on the CPU.

``raster_kernel.zscan_alpha_peels`` returns all P depth-peel planes of
the stochastic-alpha scan at once; its plain twin (what a CPU tensor
takes) is held here to P passes of ``zscan_plain``, each excluding the
winners of the passes before it, on the tie-heavy and the scrambled
synthetic tables of ``tests/test_torch_cuda_sources.py``. Then the
rasterizer's ``_visibility``, which reads the P planes, is held to the
per-pass route it replaced (one z-scan a peel, the texel law tested on
each pass's winner, the first kept layer taken) over four cutout planes
stacked above a floor, at 1, 3 and 5 peels. All exact: the same
operations in the same order.
"""

import numpy as np
import pytest
import torch

import realism_effects_tpu_torch as tre
from realism_effects_tpu_torch.core.rng import blue_noise_image
from realism_effects_tpu_torch.ops import raster_kernel
from realism_effects_tpu_torch.ops.cuda_build import launches
from realism_effects_tpu_torch.scene import rasterizer
from test_torch_cuda_sources import _synthetic_table

H, W = 45, 83


def _per_pass(tab, h, w, alpha, dither, cnmf, passes):
    """P passes of the plain z-scan, pass p excluding passes 0 .. p-1."""
    ids, zs = [], []
    for _ in range(passes):
        i, z = raster_kernel.zscan_plain(tab, h, w, alpha, dither, cnmf,
                                         torch.stack(ids) if ids else None)
        ids.append(i)
        zs.append(z)
    return torch.stack(ids), torch.stack(zs)


@pytest.mark.parametrize("case,cnmf,passes", [
    ("ties", 0.0, 3), ("ties", 3.0, 5), ("scrambled", 20.0, 4),
    ("scrambled", 3.0, 1)])
def test_plain_peels_match_per_pass(case, cnmf, passes):
    tab = _synthetic_table(case, H, W)
    rng = np.random.default_rng(passes)
    # drawn from the row's bits, so a triangle and its duplicate share it
    pick = tab.view(torch.int32)[:, :9].sum(1).remainder(4)
    alpha = torch.tensor([1.0, 0.7, 0.5, 0.3])[pick]
    dither = torch.tensor(rng.random((H, W)), dtype=torch.float32)
    launches.clear()
    ids, z = raster_kernel.zscan_alpha_peels(tab, H, W, alpha, dither, cnmf, passes)
    assert not launches   # the CPU runs plain
    want_ids, want_z = _per_pass(tab, H, W, alpha, dither, cnmf, passes)
    assert ids.shape == z.shape == (passes, H, W) and ids.dtype == torch.int32
    assert bool((ids[-1] >= 0).any())
    assert torch.equal(ids, want_ids)
    assert torch.equal(z, want_z)


def _stacked_cutouts():
    """Four planes under an alpha map with a hole of alpha 0, stacked
    above an opaque floor (``tests/test_torch_alpha.py``'s ``cutouts``)."""
    tex = np.ones((32, 32, 4), np.float32)
    tex[8:24, 8:24, 1] = 0.0
    tex[:8, :, 1] = 0.4            # a band the dither keeps in part
    scene = tre.Scene()
    scene.add(tre.make_plane(4, tre.Material(diffuse=(0.2, 0.8, 0.2, 1.0))))
    for i in range(4):
        p = scene.add(tre.make_plane(4, tre.Material(diffuse=(0.7, 0.7, 0.7, 1.0),
                                                     alpha_map=tex)))
        p.set_matrix(tre.translation(0, 1.0 + 0.2 * i, 0))
    return scene


@pytest.mark.parametrize("cnmf", [0.0, 3.0])
@pytest.mark.parametrize("peels", [1, 3, 5])
def test_visibility_matches_per_pass_route(peels, cnmf):
    h, w = 40, 56
    scene = _stacked_cutouts()
    packed = scene.pack("cpu")
    cam = tre.PerspectiveCamera(50, w / h, 0.1, 100)
    cam.set_position(0.3, 5, 0.4)
    cam.look_at((0, 0, 0))
    world, _ = rasterizer._world_transform(packed, torch.tensor(scene.model_matrices()))
    clip = rasterizer._clip_positions(world, cam.matrices().projection_view_matrix)
    dither = blue_noise_image(h, w, 11)[..., 0]
    tri_alpha, alpha_tex = rasterizer._alpha_inputs(packed, dither)

    calls = []
    real = rasterizer.zscan_alpha_peels
    rasterizer.zscan_alpha_peels = lambda *a: calls.append(a) or real(*a)
    try:
        ids, depth = rasterizer._visibility(clip, packed.faces, h, w, None, tri_alpha,
                                            dither, cnmf, alpha_tex, peels)
    finally:
        rasterizer.zscan_alpha_peels = real
    assert len(calls) == 1 and calls[0][-1] == peels

    # the per-pass route: a z-scan a peel, each excluding the raw winners
    # of the ones before, the law on each pass's winning texel
    tab = calls[0][0]
    keeps = rasterizer._texel_law(clip, packed.faces.long(), h, w, alpha_tex,
                                  tri_alpha, dither, cnmf)
    idp, zp = raster_kernel.zscan_plain(tab, h, w, tri_alpha, dither, cnmf)
    resolved = keeps(idp)
    want_ids = torch.where(resolved, idp, -1)
    want_z = torch.where(resolved, zp, float("inf"))
    exclude = [idp]
    for _ in range(1, peels):
        idp, zp = raster_kernel.zscan_plain(tab, h, w, tri_alpha, dither, cnmf,
                                            torch.stack(exclude))
        kp = keeps(idp)
        take = ~resolved & kp
        want_ids = torch.where(take, idp, want_ids)
        want_z = torch.where(take, zp, want_z)
        resolved = resolved | kp
        exclude.append(idp)
    want_depth = torch.where(want_ids >= 0, want_z * 0.5 + 0.5, 1.0)
    assert torch.equal(ids, want_ids)
    assert torch.equal(depth, want_depth)
    # more peels resolve more of the holes: the floor shows from 5 on
    floor = int((ids == 0).sum() + (ids == 1).sum())
    assert (floor > 0) == (peels == 5)
