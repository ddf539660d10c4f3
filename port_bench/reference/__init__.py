"""The plain references of the benchmark's comparison.

``port/`` is a frozen copy of the port's plain route on one device: the
modules of ``realism_effects_tpu_torch`` that the flagship and HBAO +
TRAA stacks run (composer, core, effects, ops, scene), as they stood
when this benchmark was written, and TAA (``effects/taa.py``), with
their relative imports kept inside the copy. What makes it plain and
free of the program:

- every kernel wrapper is its plain PyTorch body alone; the launches,
  the row-sharded (split-frame) route, the state's save and load and the
  copy tool are left out;
- the environment's inverse-CDF tables are built by numpy in the
  arithmetic of the program's C++ library (``native/envcdf.cpp``: float64
  luminance, sums in order), not by that library;
- SSGI's trace is an attribute of the effect (``SSGIEffect.trace``), so
  that the check can record it and the control can lower it;
- the package's ``__init__`` exports only what the benchmark builds: the
  scene, camera, environment and composer, and the effects
  ``SSGIEffect``, ``SSREffect``, ``HBAOEffect``, ``GTAOEffect``,
  ``MotionBlurEffect``, ``TRAAEffect`` and ``TAAPass``.

The copy shares the port's glue, so it is itself held to ``stages/``:
independent per-pixel references of each stage, which share no code
with it (see ``stages/__init__.py``).

Neither imports ``jax``, ``realism_effects_tpu`` or anything of
``realism_effects_tpu_torch``; the copy builds its own scene,
environment, G-buffer, velocity and state from the benchmark's inputs.
"""

from __future__ import annotations

import dataclasses

import torch


def _round(x):
    """``x`` (a tensor, or a dict, list or dataclass of tensors) with its
    floating-point tensors rounded to bfloat16 and back."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.bfloat16).to(x.dtype) if x.is_floating_point() else x
    if isinstance(x, dict):
        return {k: _round(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_round(v) for v in x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _round(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return x


def lower_precision(comp):
    """The control: ``comp`` (a reference composer) with every buffer
    that crosses a stage stored in bfloat16, the precision below the
    configuration's float32 — the G-buffer, velocity and lit colour the
    raster hands on, SSGI's trace, and each effect's output image and
    state."""
    raster = comp._raster
    comp._raster = lambda *a, **k: _round(raster(*a, **k))
    for e in comp.effects:
        apply = e.apply
        e.apply = lambda ctx, color, state, _apply=apply: _round(_apply(ctx, color, state))
        if hasattr(e, "trace"):
            trace = e.trace
            e.trace = lambda *a, _trace=trace, **k: _round(_trace(*a, **k))
