"""Carry buffers and temporal state across packages, as numpy arrays.

This system has no weights: what crosses between the JAX package and
this one is packed scenes, G-buffers, velocity buffers, environments
(the nearest thing to weights: the HDR map's mips and CDF tables) and
the composer's temporal state. Inputs may be any objects with the fields as attributes
(the JAX package's dataclasses, whose arrays convert through
``np.asarray``) or dicts of arrays. The state layout is the one
``jax.tree.map(np.asarray, composer._state)`` gives:
``{"__global__": {"last_velocity": <velocity, normal, depth>},
"<effect>": {...}}``, where a value may also be a list (the SSGI and
SSR histories: two textures and one). A port composer resumes a JAX run
from it (``EffectComposer.set_state``), TAA's ``accumulated`` included.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .core.envmap import EquirectEnv
from .core.framebuffers import GBuffer, VelocityBuffer
from .core.sampling import MipAtlas
from .scene.scene import _PACKED_DTYPES, PackedScene

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


def env_from_numpy(env, device) -> EquirectEnv:
    """The JAX package's ``EquirectEnv`` (or an object with the same
    fields) on ``device``: mips, atlas data and level shapes, marginal,
    conditional, total_sum and cdf_packed, in their stored types."""
    atlas = env.atlas
    cdf = getattr(env, "cdf_packed", None)
    return EquirectEnv(
        mips=tuple(_tensor(m, device) for m in env.mips),
        atlas=MipAtlas(_tensor(atlas.data, device),
                       tuple(tuple(int(v) for v in s) for s in atlas.shapes)),
        marginal=_tensor(env.marginal, device),
        conditional=_tensor(env.conditional, device),
        total_sum=_tensor(env.total_sum, device),
        cdf_packed=None if cdf is None else _tensor(cdf, device))


def packed_scene_from_numpy(packed, device) -> PackedScene:
    """The JAX package's ``PackedScene`` (or an object or dict with the
    same fields) on ``device``."""
    return PackedScene.from_arrays(
        {f: np.asarray(_get(packed, f)) for f in _PACKED_DTYPES}, device)


def _is_velocity(obj) -> bool:
    if isinstance(obj, Mapping):
        return set(obj) == set(_VEL_FIELDS)
    return all(hasattr(obj, f) for f in _VEL_FIELDS)


def state_from_numpy(state, device):
    """Nested dicts and lists of arrays (velocity buffers as objects or
    dicts) -> the composer's state of tensors on ``device``."""
    if _is_velocity(state):
        return velocity_from_numpy(state, device)
    if isinstance(state, Mapping):
        return {k: state_from_numpy(v, device) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [state_from_numpy(v, device) for v in state]
    return _tensor(state, device)


def state_to_numpy(state):
    """The composer's state -> nested dicts and lists of numpy arrays (a
    velocity buffer becomes a dict of its three planes)."""
    if isinstance(state, VelocityBuffer):
        return {f: getattr(state, f).cpu().numpy() for f in _VEL_FIELDS}
    if isinstance(state, Mapping):
        return {k: state_to_numpy(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [state_to_numpy(v) for v in state]
    return state.cpu().numpy()


def flatten_state(state, prefix: str = "") -> dict:
    """Nested dicts and lists -> {"a/b/c": array}: list item i is key
    "#i"; an empty dict is kept as "a/"."""
    flat = {}
    if isinstance(state, (list, tuple)):
        state = {f"#{i}": v for i, v in enumerate(state)}
    if not state:
        flat[prefix] = np.zeros(0, np.float32)
    for key, val in state.items():
        path = f"{prefix}{key}"
        if isinstance(val, (Mapping, list, tuple)):
            flat.update(flatten_state(val, path + "/"))
        else:
            flat[path] = val
    return flat


def _lists(node):
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.startswith("#") for k in node):
        return [node[f"#{i}"] for i in range(len(node))]
    return node


def unflatten_state(flat: dict) -> dict:
    out: dict = {}
    for path, val in flat.items():
        parts = path.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if parts[-1]:
            node[parts[-1]] = val
    return _lists(out)
