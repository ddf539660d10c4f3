"""The active row mesh, for kernels that shard themselves.

Two routes split a frame over a mesh of devices:

- The split frame (``EffectComposer._build_frame_fn(mesh)``, the JAX
  package's ``shard_frame_fn`` frame): the frame's images and its
  temporal state are held as row blocks (``sharding.RowBlocks``), and
  each stage runs per shard on halo-extended blocks or whole on the
  composer's device, as ``parallel/__init__.py``'s table sets out. Code that
  runs per shard runs with no mesh installed here, so no wrapper splits
  a block again.
- Inside ``mesh_context(mesh)`` around ``render()``: the four
  bounded-window wrappers (``ops/warp.py::window_warp`` and
  ``window_warp_multi``, ``ops/hbao_kernel.py::hbao_fused``,
  ``ops/poisson_kernel.py::poisson_pass_fused``) split their whole-frame
  input over the mesh, exchange halo rows, launch per shard on the
  shard's device and gather the result back. Everything else runs on the
  composer's device.

A mesh is an ordered tuple of ``torch.device`` (``sharding.make_mesh``);
a device may repeat, so one card (or the CPU) can stand for several.
"""

from __future__ import annotations

import contextlib
import contextvars

_ACTIVE_MESH = contextvars.ContextVar("re_torch_active_mesh", default=None)


def current_mesh():
    """The mesh installed by the enclosing :func:`mesh_context`, or None."""
    return _ACTIVE_MESH.get()


def row_mesh_for(height: int):
    """The active mesh if ``height`` rows divide evenly over it (the
    precondition of the row-sharded routes), else None."""
    mesh = _ACTIVE_MESH.get()
    if mesh is None:
        return None
    n = len(mesh)
    if height % n != 0 or height < n:
        return None
    return mesh


@contextlib.contextmanager
def mesh_context(mesh):
    """Install ``mesh`` (a tuple of devices) for the enclosed calls."""
    token = _ACTIVE_MESH.set(None if mesh is None else tuple(mesh))
    try:
        yield
    finally:
        _ACTIVE_MESH.reset(token)


def replicate_for_rolls(*arrays, device=None):
    """Its inputs with every ``RowBlocks`` joined into one whole-frame
    tensor on ``device`` (default: block 0's); tensors and None stay as
    they are. One array in, one out; several, a tuple.

    In the JAX package this constrains the sweep tracers' roll sources to
    be replicated under a mesh, so that each per-step roll is local. In
    the split frame the sources that a stage reads at any distance (the
    SSGI trace's depth, planes and radiance, motion blur's colour) are
    gathered once a frame through here; a whole-frame tensor is already
    what every such read needs."""
    from .sharding import gather_rows, is_blocks

    out = tuple(gather_rows(a, device) if is_blocks(a) else a for a in arrays)
    return out if len(out) > 1 else out[0]
