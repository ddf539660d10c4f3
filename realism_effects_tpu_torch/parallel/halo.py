"""Halo exchange of row blocks, the per-shard map of the split frame,
and the row-sharded Poisson denoise.

A stencil with bounded vertical support runs on each row block extended
by ``halo`` rows copied from its neighbours' devices; at the frame's top
and bottom the halo is the edge row repeated (the clamp-to-edge of the
single-device stencils). The extended block's result is cropped back to
the block. The port of the JAX package's ``parallel/halo.py``, with
``torch.Tensor.to`` in place of ``ppermute`` and a Python loop over the
shards in place of ``shard_map``.

The split frame (``EffectComposer._build_frame_fn(mesh)``) runs its
per-shard stages through :func:`map_shards`, placed as the table in the
package's docstring (``parallel/__init__.py``) sets out.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from ..ops.copy import tree_map
from ..ops.poisson_denoise import (PoissonDenoiseConfig, ao_config, ao_texture,
                                   poisson_denoise_pass)
from .sharding import (RowBlocks, gather_pytree, gather_rows, is_blocks,
                       shard_rows, split_images)


def device_scope(device):
    """Make ``device`` current for the kernels launched inside (a CUDA
    launch goes to the current device)."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def halo_exchange_rows(blocks, halo: int, dim: int = 0) -> list:
    """Extend each of the equal row blocks ``blocks`` (block ``i`` the
    rows ``i * h_loc ..`` of the frame) by ``halo`` rows on each side,
    copied from the neighbouring blocks onto its device: ceil(halo /
    h_loc) blocks each way when the halo passes a block's height. Rows
    beyond the frame repeat its first or last row."""
    n = len(blocks)
    h_loc = blocks[0].shape[dim]
    hops = -(-halo // h_loc) if halo > 0 else 0
    out = []
    for i, b in enumerate(blocks):
        lo, hi = max(0, i - hops), min(n - 1, i + hops)
        near = torch.cat([blocks[j].to(b.device) for j in range(lo, hi + 1)],
                         dim=dim)
        rows = torch.arange(i * h_loc - halo, (i + 1) * h_loc + halo,
                            device=b.device).clamp_(0, n * h_loc - 1)
        out.append(near.index_select(dim, rows - lo * h_loc))
    return out


def edge_pad_rows(x: torch.Tensor, halo: int, dim: int = 0) -> torch.Tensor:
    """``x`` with its first and last row repeated ``halo`` times along
    ``dim`` (the JAX ``jnp.pad(..., mode="edge")``)."""
    if halo <= 0:
        return x
    first = x.narrow(dim, 0, 1)
    last = x.narrow(dim, x.shape[dim] - 1, 1)
    reps = [1] * x.ndim
    reps[dim] = halo
    return torch.cat([first.repeat(reps), x, last.repeat(reps)], dim=dim)


def crop_rows(x: torch.Tensor, halo: int, dim: int = 0) -> torch.Tensor:
    return x.narrow(dim, halo, x.shape[dim] - 2 * halo)


def _leaves(tree) -> list:
    out = []
    tree_map(out.append, tree, is_leaf=is_blocks)
    return out


def map_shards(fn, mesh, halo: int, *trees):
    """Run ``fn`` once per shard of ``mesh`` on halo-extended row blocks.

    ``trees`` are nested dicts/lists/tuples/dataclasses (a
    ``FrameContext``, a G-buffer, a state dict). Shard ``i`` sees each
    :class:`RowBlocks` leaf as its block ``i`` extended by ``halo`` rows
    from the neighbouring blocks (the edge row repeated past the frame's
    top and bottom), each other tensor leaf copied to its device, and
    every other leaf as it is. ``fn(row0, *trees_i)`` runs with the
    shard's device current; ``row0`` is the global row of the extended block's
    first row (negative on the first shard). Every tensor leaf of its
    result has the extended block's rows first; the result comes back
    with each of them cropped to the shard's own rows and joined over the
    shards as :class:`RowBlocks`, other leaves taken from shard 0."""
    n = len(mesh)
    blocks = [x for t in trees for x in _leaves(t) if is_blocks(x)]
    if not blocks:
        raise ValueError("map_shards(): no RowBlocks among the inputs")
    for b in blocks:
        if len(b) != n:
            raise ValueError(f"{len(b)} row blocks for a mesh of {n}")
    h_loc = int(blocks[0][0].shape[0])
    ext = {id(b): (halo_exchange_rows(b, halo) if halo > 0 else list(b))
           for b in blocks}
    first, outs = None, []
    for i, dev in enumerate(mesh):
        def pick(x):
            if is_blocks(x):
                return ext[id(x)][i]
            if isinstance(x, torch.Tensor):
                return x.to(dev)
            return x
        args = [tree_map(pick, t, is_leaf=is_blocks) for t in trees]
        with device_scope(dev):
            out = fn(i * h_loc - halo, *args)
        first = out if first is None else first
        outs.append(_leaves(out))
    joined = iter([
        RowBlocks(crop_rows(o[k], halo) for o in outs)
        if isinstance(outs[0][k], torch.Tensor) else outs[0][k]
        for k in range(len(outs[0]))])
    return tree_map(lambda _: next(joined), first, is_leaf=is_blocks)


@dataclasses.dataclass
class SplitFrame:
    """What the stages of one split frame share: the mesh, the
    composer's device (``home``, where "whole" stages run), the frame's
    size, and the placement each stage reported."""

    mesh: tuple
    home: torch.device
    height: int
    width: int
    placement: dict = dataclasses.field(default_factory=dict)

    def map(self, fn, halo: int, *trees):
        """:func:`map_shards` over this frame's mesh."""
        return map_shards(fn, self.mesh, halo, *trees)

    def split(self, tree):
        """Image-like tensor leaves of ``tree`` as row blocks
        (``sharding.split_images``)."""
        return split_images(tree, self.mesh)

    def gather(self, tree):
        """Row-block leaves of ``tree`` as whole tensors on ``home``."""
        return gather_pytree(tree, self.home)


def poisson_denoise_blocks(textures, gbuffer, frame: int,
                           cfg: PoissonDenoiseConfig, mesh, resolution,
                           scalar_slots=None):
    """Row-sharded Poisson denoise on row blocks: ``textures`` a list of
    (H, W, 4) :class:`RowBlocks`, ``gbuffer`` a G-buffer of them, the
    frame ``resolution`` (H, W). Each of the ``2 * iterations`` passes
    exchanges its halo again (a pass reads the previous pass's output in
    the halo) and runs ``poisson_denoise_pass(..., row_offset=,
    resolution=)`` on each extended block on its shard's device; the
    values of ``ops.poisson_denoise.poisson_denoise``. Returns the list
    of textures as :class:`RowBlocks`."""
    hg, wg = int(resolution[0]), int(resolution[1])
    # a pass reads the depth, normal and roughness planes alone
    gbuffer = dataclasses.replace(gbuffer, diffuse=None, metalness=None,
                                  emissive=None, mesh_id=None, ao=None)
    # the tap offsets rotate in global uv, so the vertical reach is bounded
    # by radius * hypot(1, H / W); 2 more rows cover the snap and rounding
    halo = int(math.ceil(cfg.radius * math.hypot(1.0, hg / wg))) + 2
    n_passes = 2 * cfg.iterations
    textures = list(textures)
    for p in range(n_passes):
        textures = list(map_shards(
            lambda row0, texs, gb: tuple(poisson_denoise_pass(
                list(texs), gb, frame * n_passes + p, cfg, row_offset=row0,
                resolution=(hg, wg), scalar_slots=scalar_slots)),
            mesh, halo, textures, gbuffer))
    return textures


def poisson_denoise_ao_blocks(ao, gbuffer, frame: int,
                              cfg: PoissonDenoiseConfig, mesh, resolution):
    """``ops.poisson_denoise.poisson_denoise_ao`` on row blocks: ``ao``
    (H, W) :class:`RowBlocks`, the result too."""
    tex = map_shards(lambda _row0, a: ao_texture(a), mesh, 0, ao)
    (out,) = poisson_denoise_blocks([tex], gbuffer, frame, ao_config(cfg), mesh,
                                    resolution, scalar_slots=(True,))
    return map_shards(lambda _row0, t: torch.clamp(t[..., 0], 0.0, 1.0), mesh,
                      0, out)


def poisson_denoise_sharded(textures, gbuffer, frame: int,
                            cfg: PoissonDenoiseConfig, mesh):
    """Row-sharded Poisson denoise of whole-frame (H, W, 4) ``textures``
    (:func:`poisson_denoise_blocks` on their blocks), the values of
    ``ops.poisson_denoise.poisson_denoise``; returns whole-frame textures
    on the input's device."""
    home = textures[0].device
    out = poisson_denoise_blocks(
        [shard_rows(t, mesh) for t in textures], split_images(gbuffer, mesh),
        frame, cfg, mesh, tuple(textures[0].shape[:2]))
    return [gather_rows(t, home) for t in out]
