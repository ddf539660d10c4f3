"""History-snapshot helpers (the reference's ``CopyPass``).

The reference's ``CopyPass`` (`src/ssgi/pass/CopyPass.js`) and its
``copyFramebufferToTexture`` calls double-buffer history textures in
WebGL. The composer's state is replaced frame by frame, so a copy pass
is bookkeeping; these helpers keep the JAX package's API and snapshot
device buffers to the host.
"""

from __future__ import annotations

import dataclasses

import torch


def copy_textures(textures):
    """MRT copy (`CopyPass.js:16-57`): independent copies on the same
    device."""
    return [t.clone() for t in textures]


def tree_map(fn, tree, is_leaf=None):
    """``fn`` applied to every leaf of a nested dict/list/tuple/dataclass
    (the ``jax.tree_util.tree_map`` of the JAX package's helpers); the
    containers keep their types. ``is_leaf(node)`` true stops the descent
    there (a container that is one leaf)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    rec = lambda v: tree_map(fn, v, is_leaf)
    if isinstance(tree, dict):
        return {k: rec(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [rec(v) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: rec(getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return fn(tree)


def snapshot_to_host(tree):
    """Every tensor leaf of a nested dict/list/tuple/dataclass as a numpy
    array on the host (``readRenderTargetPixels``); other leaves stay."""
    return tree_map(lambda x: x.detach().cpu().numpy()
                    if isinstance(x, torch.Tensor) else x, tree)
