"""Row sharding of (H, W[, C]) frames over a 1-D mesh of devices.

The JAX package shards image rows over a device mesh and lets GSPMD
place the collectives. The port keeps its single-controller design with
explicit objects: a mesh is an ordered tuple of ``torch.device`` and a
row-sharded array is a :class:`RowBlocks`, a list of equal row blocks,
block ``i`` on device ``i`` of the mesh.

JAX's ``row_sharding(mesh)`` and ``replicated(mesh)`` return
``NamedSharding`` objects, which torch has no counterpart of; the port
leaves them out and :func:`shard_pytree` applies the same rule itself:
split into row blocks, or one copy on each device.

Usage::

    mesh = make_mesh()                      # every visible CUDA device
    mesh = make_mesh(["cuda:0"] * 4)        # four shards on one card
    frame_fn = composer._build_frame_fn(mesh)   # the split frame
    image, state = frame_fn(*args)          # RowBlocks, state as blocks
"""

from __future__ import annotations

import torch

from ..ops.copy import tree_map

ROW_AXIS = "rows"


class RowBlocks(list):
    """The row blocks of one frame-sized tensor, in order: block ``i``
    holds rows ``i * h_loc .. (i + 1) * h_loc`` on device ``i`` of the
    mesh. A list, so a tree walk can tell it from a tensor leaf."""


def is_blocks(x) -> bool:
    return isinstance(x, RowBlocks)


def make_mesh(devices=None) -> tuple:
    """A 1-D row mesh: ``devices`` (names or ``torch.device``; a device
    may repeat), by default every visible CUDA device. Raises when no
    device is named and CUDA has none; it never falls back to the CPU."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("make_mesh(): no CUDA device; name the devices "
                               "(e.g. make_mesh(['cpu'] * 4)) to shard elsewhere")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("make_mesh(): an empty device list")
    return mesh


def is_row_shardable(x, mesh) -> bool:
    """The JAX ``_spec_for`` rule: image-like (ndim >= 2) with H divisible
    by the mesh size and at least the mesh size."""
    n = len(mesh)
    return (isinstance(x, torch.Tensor) and x.ndim >= 2 and x.shape[0] % n == 0
            and x.shape[0] >= n)


def shard_rows(x: torch.Tensor, mesh, dim: int = 0) -> RowBlocks:
    """Split ``x`` into ``len(mesh)`` equal blocks along ``dim``, block
    ``i`` on device ``i``."""
    n = len(mesh)
    if x.shape[dim] % n != 0:
        raise ValueError(f"{x.shape[dim]} rows do not divide over {n} shards")
    return RowBlocks(b.to(d) for b, d in zip(torch.chunk(x, n, dim=dim), mesh))


def gather_rows(blocks, device=None, dim: int = 0) -> torch.Tensor:
    """Join row blocks along ``dim`` on ``device`` (default: block 0's)."""
    device = blocks[0].device if device is None else device
    return torch.cat([b.to(device) for b in blocks], dim=dim)


def shard_pytree(tree, mesh):
    """Place every tensor leaf of a nested dict/list/tuple/dataclass:
    image-like leaves as :class:`RowBlocks`, the others as one copy per
    device (a list); leaves already in blocks and other leaves stay as
    they are."""
    def place(x):
        if not isinstance(x, torch.Tensor):
            return x
        if is_row_shardable(x, mesh):
            return shard_rows(x, mesh)
        return [x.to(d) for d in mesh]

    return tree_map(place, tree, is_leaf=is_blocks)


def split_images(tree, mesh):
    """``tree`` with its image-like tensor leaves as :class:`RowBlocks`
    over ``mesh``; blocks already there and every other leaf stay."""
    return tree_map(lambda x: shard_rows(x, mesh) if is_row_shardable(x, mesh)
                    else x, tree, is_leaf=is_blocks)


def gather_pytree(tree, device=None):
    """``tree`` with every :class:`RowBlocks` leaf joined into one tensor
    on ``device`` (default: each leaf's block 0 device)."""
    return tree_map(lambda x: gather_rows(x, device) if is_blocks(x) else x,
                    tree, is_leaf=is_blocks)


def replicate_for_rolls(*arrays, device=None):
    """Its inputs with every :class:`RowBlocks` joined into one
    whole-frame tensor on ``device`` (default: block 0's); tensors and
    None stay as they are. One array in, one out; several, a tuple.

    In the JAX package this constrains the sweep tracers' roll sources to
    be replicated under a mesh, so that each per-step roll is local. In
    the split frame the sources that a stage reads at any distance (the
    SSGI trace's depth, planes and radiance, motion blur's colour) are
    gathered once a frame through here; a whole-frame tensor is already
    what every such read needs."""
    out = tuple(gather_rows(a, device) if is_blocks(a) else a for a in arrays)
    return out if len(out) > 1 else out[0]
