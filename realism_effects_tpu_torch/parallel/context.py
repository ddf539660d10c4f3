"""The active row mesh, for kernels that shard themselves.

The JAX package installs a mesh here while it traces a row-sharded frame
function; its bounded-window kernels (the window warps, fused HBAO, the
fused Poisson pass) then run per shard on halo-extended row blocks. The
port keeps that design without a tracer: inside ``mesh_context(mesh)``
the same four wrappers (``ops/warp.py::window_warp`` and
``window_warp_multi``, ``ops/hbao_kernel.py::hbao_fused``,
``ops/poisson_kernel.py::poisson_pass_fused``) split their input over
the mesh, exchange halo rows, launch per shard on the shard's device and
gather the result back. Everything else runs on the composer's device.

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


def replicate_for_rolls(*arrays):
    """Returns its inputs (one array, or a tuple of them).

    In the JAX package this constrains the sweep tracers' roll sources to
    be replicated under a mesh, so that GSPMD lowers each per-step roll
    locally instead of as a chain of collective permutes. In the port the
    sweep tracers run on whole frames on the composer's device: a
    whole-frame tensor there is already what every roll reads."""
    return arrays if len(arrays) > 1 else arrays[0]
