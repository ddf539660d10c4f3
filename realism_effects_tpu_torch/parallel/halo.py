"""Halo exchange of row blocks, and the row-sharded Poisson denoise.

A stencil with bounded vertical support runs on each row block extended
by ``halo`` rows copied from its neighbours' devices; at the frame's top
and bottom the halo is the edge row repeated (the clamp-to-edge of the
single-device stencils). The extended block's result is cropped back to
the block. The port of the JAX package's ``parallel/halo.py``, with
``torch.Tensor.to`` in place of ``ppermute`` and a Python loop over the
shards in place of ``shard_map``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from ..ops.poisson_denoise import PoissonDenoiseConfig, poisson_denoise_pass
from .sharding import gather_rows, shard_rows


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


def map_row_blocks(fn, mesh, halo: int, exchanged, padded=(), padded_dim=0,
                   out_dim=0):
    """Run ``fn`` per shard of ``mesh`` on halo-extended row blocks of the
    whole-frame tensors ``exchanged`` (rows from the neighbouring shards)
    and ``padded`` (per-pixel inputs, rows ``padded_dim``: edge-padded, as
    only the shard's own rows are kept), and gather the cropped results
    onto the device of ``exchanged[0]``.

    ``fn(row0, *exchanged_blocks, *padded_blocks)`` runs with the shard's
    device current; ``row0`` is the global row of its block's first row
    (negative on the first shard). It returns a tensor or a tuple of
    tensors whose rows are dimension ``out_dim``."""
    n = len(mesh)
    home = exchanged[0].device
    h_loc = exchanged[0].shape[0] // n
    ext = list(zip(*[halo_exchange_rows(shard_rows(x, mesh), halo)
                     for x in exchanged]))
    pads = list(zip(*[[edge_pad_rows(b, halo, padded_dim)
                       for b in shard_rows(x, mesh, padded_dim)]
                      for x in padded])) or [()] * n
    outs = []
    for i, dev in enumerate(mesh):
        with device_scope(dev):
            outs.append(fn(i * h_loc - halo, *ext[i], *pads[i]))
    if isinstance(outs[0], tuple):
        return tuple(gather_rows([crop_rows(o[k], halo, out_dim) for o in outs],
                                 home, out_dim) for k in range(len(outs[0])))
    return gather_rows([crop_rows(o, halo, out_dim) for o in outs], home, out_dim)


def poisson_denoise_sharded(textures, gbuffer, frame: int,
                            cfg: PoissonDenoiseConfig, mesh):
    """Row-sharded Poisson denoise, the values of
    ``ops.poisson_denoise.poisson_denoise``: each of the ``2 *
    iterations`` passes exchanges its halo again (a pass reads the
    previous pass's output in the halo), runs
    ``poisson_denoise_pass(..., row_offset=, resolution=(H, W))`` on each
    extended block on its shard's device, and crops. Takes and returns
    whole-frame (H, W, 4) textures on the input's device."""
    hg, wg = int(textures[0].shape[0]), int(textures[0].shape[1])
    # the tap offsets rotate in global uv, so the vertical reach is bounded
    # by radius * hypot(1, H / W); 2 more rows cover the snap and rounding
    halo = int(math.ceil(cfg.radius * math.hypot(1.0, hg / wg))) + 2
    fields = [f.name for f in dataclasses.fields(gbuffer)
              if isinstance(getattr(gbuffer, f.name), torch.Tensor)]
    planes = [getattr(gbuffer, f) for f in fields]
    nt = len(textures)
    n_passes = 2 * cfg.iterations

    def one_pass(p):
        def fn(row0, *blocks):
            gb = dataclasses.replace(gbuffer, **dict(zip(fields, blocks[nt:])))
            return tuple(poisson_denoise_pass(
                list(blocks[:nt]), gb, frame * n_passes + p, cfg,
                row_offset=row0, resolution=(hg, wg)))
        return fn

    for p in range(n_passes):
        textures = list(map_row_blocks(one_pass(p), mesh, halo,
                                       [*textures, *planes]))
    return textures


def sharded_stencil(fn, mesh, halo: int, num_outputs: int = 1):
    """``fn`` (whole-height tensors in, ``num_outputs`` whole-height
    tensors out) run per shard of ``mesh`` on halo-extended row blocks of
    its whole-frame arguments, the results cropped and gathered onto the
    first argument's device."""
    def wrapped(*arrays):
        out = map_row_blocks(lambda _row0, *blocks: fn(*blocks), mesh, halo,
                             list(arrays))
        if num_outputs != 1 and not isinstance(out, tuple):
            raise ValueError(f"fn returned one tensor, not {num_outputs}")
        return out

    return wrapped
