"""Carry buffers and temporal state across packages, as numpy arrays.

This system has no weights: what crosses between the JAX package and
this one is G-buffers, velocity buffers and the composer's temporal
state. Inputs may be any objects with the fields as attributes (the JAX
package's dataclasses, whose arrays convert through ``np.asarray``) or
dicts of arrays. The state layout is the one
``jax.tree.map(np.asarray, composer._state)`` gives:
``{"__global__": {"last_velocity": <velocity, normal, depth>},
"<effect>": {...}}``.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .core.framebuffers import GBuffer, VelocityBuffer

_GB_FIELDS = ("diffuse", "normal", "roughness", "metalness", "emissive",
              "depth")
_GB_OPTIONAL = ("mesh_id", "ao")
_VEL_FIELDS = ("velocity", "normal", "depth")


def _get(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name, None)


def _tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.tensor(arr, device=device)


def gbuffer_from_numpy(gb, device) -> GBuffer:
    fields = {f: _tensor(_get(gb, f), device) for f in _GB_FIELDS}
    for f in _GB_OPTIONAL:
        v = gb.get(f) if isinstance(gb, Mapping) else getattr(gb, f, None)
        if v is not None:
            fields[f] = _tensor(v, device)
    return GBuffer(**fields)


def velocity_from_numpy(vel, device) -> VelocityBuffer:
    return VelocityBuffer(**{f: _tensor(_get(vel, f), device)
                             for f in _VEL_FIELDS})


def _is_velocity(obj) -> bool:
    if isinstance(obj, Mapping):
        return set(obj) == set(_VEL_FIELDS)
    return all(hasattr(obj, f) for f in _VEL_FIELDS)


def state_from_numpy(state, device) -> dict:
    """Nested dict of arrays (velocity buffers as objects or dicts) ->
    the composer's state of tensors on ``device``."""
    out = {}
    for key, val in state.items():
        if _is_velocity(val):
            out[key] = velocity_from_numpy(val, device)
        elif isinstance(val, Mapping):
            out[key] = state_from_numpy(val, device)
        else:
            out[key] = _tensor(val, device)
    return out


def state_to_numpy(state) -> dict:
    """The composer's state -> nested dict of numpy arrays (a velocity
    buffer becomes a dict of its three planes)."""
    out = {}
    for key, val in state.items():
        if isinstance(val, VelocityBuffer):
            out[key] = {f: getattr(val, f).cpu().numpy() for f in _VEL_FIELDS}
        elif isinstance(val, Mapping):
            out[key] = state_to_numpy(val)
        else:
            out[key] = val.cpu().numpy()
    return out


def flatten_state(state: dict, prefix: str = "") -> dict:
    """Nested dict -> {"a/b/c": array}; an empty dict is kept as "a/"."""
    flat = {}
    if not state:
        flat[prefix] = np.zeros(0, np.float32)
    for key, val in state.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            flat.update(flatten_state(val, path + "/"))
        else:
            flat[path] = val
    return flat


def unflatten_state(flat: dict) -> dict:
    out: dict = {}
    for path, val in flat.items():
        parts = path.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if parts[-1]:
            node[parts[-1]] = val
    return out
