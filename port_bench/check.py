"""The comparison that decides ``correct``.

Two frames the program rendered through ``EffectComposer.render`` are
held against the plain reference (``reference/port``) at the cell's own
size, once the window has closed and the program is freed:

- ``start``: the last warm-up frame. The reference renders the warm-up
  frames itself from its own empty state, so this checks the start of
  the temporal feedback with nothing taken from the program;
- ``last``: the window's last frame. Replaying a whole window on the
  plain route would take several times the window, so the reference
  takes the program's own state before the window's last
  ``compare.frames`` frames (the composer's public ``state()``), with the
  camera, matrices and counters of those frames worked out from the
  inputs, and renders them one after another: what the program's
  temporal feedback makes of several steps is compared, not one step.

Each frame compares the image ``render`` returned and every leaf of the
temporal state carried to the next frame: SSGI's two denoised histories
(SSR's one) and composed output, TRAA's history, TAA's accumulation and
the raster's velocity buffer (velocity, depth, normals). See :func:`numbers` for what is compared.

``stages``: the frozen copy shares the port's glue, so on the last
warm-up frame of ``start`` each stage's inputs and outputs in the copy
are recorded (:class:`Recorder`) and each stage that has an independent
reference is given the same inputs; its outputs are held against the
copy's (:func:`stage_numbers`). The reference is chosen by the stage's
name and mode (:func:`reference_name`): ``reference/stages/<stage>.py``
in the stage's default mode, ``<stage>_<mode>.py`` in another, so a
stage is never held against another mode's reference.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util

import numpy as np
import torch

from . import reference
from .reference import port as ref_pkg
from .rig import Rig


def flatten(tree, prefix: str = "") -> dict:
    """{dotted path: tensor} of the tensors of ``tree`` (dicts, lists,
    dataclasses)."""
    out = {}
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}.{i}"))
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            out.update(flatten(getattr(tree, f.name), f"{prefix}.{f.name}"))
    return out


def outputs(image, state) -> dict:
    """The compared tensors of a frame: ``image`` and the state's float
    leaves, as float32, by name."""
    leaves = {"image": image}
    leaves.update({f"state.{k}": v for k, v in flatten(state).items()
                   if v.is_floating_point()})
    return {k: v.float() for k, v in leaves.items()}


def gaps(prog: dict, ref: dict) -> dict:
    """{leaf: (largest gap over the reference's largest magnitude (at
    least 1), mean gap over the reference's mean magnitude)} of two
    :func:`outputs` with the same leaves."""
    if set(prog) != set(ref):
        raise ValueError(f"program leaves {sorted(prog)} != reference "
                         f"leaves {sorted(ref)}")
    per = {}
    for k in prog:
        p, r = prog[k], ref[k].to(prog[k].device)
        if p.shape != r.shape:
            raise ValueError(f"{k}: program {tuple(p.shape)} reference {tuple(r.shape)}")
        d = (p - r).abs()
        d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
        per[k] = (float(d.max()) / max(float(r.abs().max()), 1.0),
                  float(d.mean()) / max(float(r.abs().mean()), 1e-12))
    return per


def numbers(prog: dict, ref: dict) -> tuple:
    """The numbers compared for one frame (``prog`` and ``ref`` from
    :func:`outputs`): for the image and for the worst state leaf, the
    largest and the mean gap of :func:`gaps`; and the gaps by leaf."""
    per = gaps(prog, ref)
    state = [v for k, v in per.items() if k != "image"]
    return {"image_max": per["image"][0], "image_mean": per["image"][1],
            "state_max": max(v[0] for v in state),
            "state_mean": max(v[1] for v in state)}, per


#: the stages whose algorithm is an option of their effect: {stage:
#: (the option, read from the effect, and the mode whose reference keeps
#: the stage's own name)}
MODES = {"ssgi_trace": (lambda effect: effect.cfg.trace, "sweep"),
         "ssr_trace": (lambda effect: effect.cfg.trace, "sweep"),
         "motion_blur": (lambda effect: effect.mode, "sweep")}


class Recorder:
    """While entered, records each stage of the reference composer
    ``comp``: {effect name: {"ctx", "color", "state", "out", "effect",
    "mode"}} of the last frame rendered, ``effect`` the stage's effect
    and ``mode`` its mode where :data:`MODES` names the stage (else
    None). SSGI's and SSR's trace outputs go under its ``"trace"``, and
    the trace is recorded as a stage of its own, ``<stage>_trace``
    (``ssgi_trace``, ``ssr_trace``), whose output is
    (g_diffuse, {"specular": g_specular}); the raster and shade as
    ``raster``, with the scene, matrices, cameras and environment it was
    given, its output (lit colour, {"gbuffer", "velocity"})."""

    def __init__(self, comp):
        self.comp = comp
        self.records: dict = {}

    def __enter__(self):
        traced_out = []
        self._traces = []
        for e in self.comp.effects:
            if not hasattr(e, "trace"):
                continue
            self._traces.append((e, e.__dict__.get("trace")))

            def traced(*a, _trace=e.trace, **k):
                out = _trace(*a, **k)
                traced_out[:] = [out]
                return out
            e.trace = traced
        comp = self.comp
        raster = self._raster = comp._raster

        def rastered(packed, model, prev_model, cam, unjit, prev, env, *a, **k):
            out = raster(packed, model, prev_model, cam, unjit, prev, env, *a, **k)
            gb, vel, color = out[0], out[1], out[2]
            keep = ("diffuse", "normal", "roughness", "metalness", "emissive", "depth")
            self.records["raster"] = dict(
                scene=comp.scene, model=model, prev_model=prev_model, cam=cam,
                unjit=unjit, prev=prev, env=env, height=comp.height, width=comp.width,
                device=gb.depth.device,
                out=(color, {"gbuffer": {**{f: getattr(gb, f) for f in keep},
                                         "mesh": gb.mesh_id.float()},
                             "velocity": {f: getattr(vel, f)
                                          for f in ("velocity", "normal", "depth")}}))
            return out

        comp._raster = rastered
        self._applies = [e.__dict__.get("apply") for e in self.comp.effects]
        for e in self.comp.effects:
            def apply(ctx, color, state, _apply=e.apply, _name=e.name, _effect=e):
                traced_out.clear()
                out = _apply(ctx, color, state)
                rec = dict(ctx=ctx, color=color, state=state, out=out, effect=_effect,
                           mode=_mode(_name, _effect))
                if traced_out:
                    # the trace as a stage of its own: its two textures
                    g_diffuse, g_specular = traced_out[0]
                    rec["trace"] = traced_out[0]
                    self.records[f"{_name}_trace"] = dict(
                        rec, out=(g_diffuse, {"specular": g_specular}),
                        mode=_mode(f"{_name}_trace", _effect))
                self.records[_name] = rec
                return out
            e.apply = apply
        return self

    def __exit__(self, *exc):
        self.comp._raster = self._raster
        for e, trace in self._traces:
            if trace is None:
                del e.trace
            else:
                e.trace = trace
        for e, apply in zip(self.comp.effects, self._applies):
            if apply is None:
                del e.apply
            else:
                e.apply = apply


def _mode(stage: str, effect):
    """The mode of ``stage`` on ``effect`` (:data:`MODES`), or None."""
    return MODES[stage][0](effect) if stage in MODES else None


def reference_name(stage: str, mode) -> str:
    """The name of ``stage``'s reference in ``mode``: the stage's own in
    its default mode (or where it has none), ``<stage>_<mode>`` in
    another."""
    if mode is None or mode == MODES[stage][1]:
        return stage
    return f"{stage}_{mode}"


def stage_module(name: str):
    """``reference/stages/<name>.py``, or None where the stage has none."""
    full = f"{__package__}.reference.stages.{name}"
    if importlib.util.find_spec(full) is None:
        return None
    return importlib.import_module(full)


def stage_numbers(records: dict) -> tuple:
    """({"<reference>_mean"}, gaps by leaf) of each recorded stage that
    has an independent reference of its mode (:func:`reference_name`):
    its outputs given the recorded inputs, against the frozen copy's; the
    number is the worst leaf's mean gap over its mean magnitude
    (:func:`gaps`), or what the stage's module computes where it defines
    ``numbers(prog, ref) -> (numbers, gaps by leaf)``. A stage that has
    a reference in its default mode but none in its own raises
    ``LookupError``: it is neither skipped nor held against another
    mode's reference.
    The largest gaps are printed but not compared: a per-pixel threshold
    (a hit, a window edge, a weight's cut-off, a triangle's edge) that two
    float orderings decide differently moves single pixels by as much as
    the control does."""
    nums, per_all = {}, {}
    for stage, rec in records.items():
        name = reference_name(stage, rec.get("mode"))
        mod = stage_module(name)
        if mod is None:
            if name != stage and stage_module(stage) is not None:
                raise LookupError(f"stage {stage!r} in mode {rec['mode']!r} has no "
                                  f"reference: reference/stages/{name}.py is missing")
            continue
        image, state = mod.step(rec)
        prog, ref = outputs(*rec["out"]), outputs(image, state)
        if hasattr(mod, "numbers"):
            got, per = mod.numbers(prog, ref)
        else:
            per = gaps(prog, ref)
            got = {f"{name}_mean": max(v[1] for v in per.values())}
        nums.update(got)
        per_all.update({f"{name}.{k}": v for k, v in per.items()})
    return nums, per_all


def to_host(tree: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}


def reference_start(cell, inputs, device, lower: bool = False) -> tuple:
    """The reference's last warm-up frame, from its own empty state, and
    the records of its stages on that frame (:class:`Recorder`)."""
    rig = Rig(ref_pkg, cell, inputs, device)
    if lower:
        reference.lower_precision(rig.comp)
    for f in range(inputs.warmup - 1):
        rig.render(f)
    with Recorder(rig.comp) as rec:
        image = rig.render(inputs.warmup - 1)
    return outputs(image, rig.state()), rec.records


def _world(rig, f: int) -> np.ndarray:
    """The camera's world matrix at frame ``f`` (sets the rig's camera)."""
    pos, target = rig.inputs.camera(f)
    rig.camera.set_position(*pos)
    rig.camera.look_at(target)
    return np.array(rig.camera.matrix_world, np.float64)


def still_frames(rig, frame: int) -> int:
    """The composer's count of frames the camera has stood still after
    frame ``frame``: the run of frames up to ``frame`` whose world matrix
    is within 1e-6 of the frame before's (``composer.py``'s rule)."""
    n, world = 0, _world(rig, frame)
    for k in range(frame, 0, -1):
        before = _world(rig, k - 1)
        if np.abs(before - world).max() > 1e-6:
            break
        n, world = n + 1, before
    return n


def reference_step(cell, inputs, state_in: dict, first: int, last: int, device,
                   lower: bool = False) -> dict:
    """The reference's frame ``last``, rendered through frames ``first``
    to ``last`` from ``state_in`` (the state after frame ``first - 1``):
    the camera and meshes of frame ``first - 1`` become the previous ones,
    with the still-camera count after that frame."""
    rig = Rig(ref_pkg, cell, inputs, device)
    if lower:
        reference.lower_precision(rig.comp)
    still = still_frames(rig, first - 1)
    rig.pose(first - 1)
    rig.comp.scene.commit_frame()
    cam = rig.camera
    cam.clear_view_offset()
    rig.comp.set_state(state_in, first, still, cam.matrix_world.copy(),
                       cam.projection_matrix.copy())
    for f in range(first, last + 1):
        image = rig.render(f)
    return outputs(image, rig.state())


def judge(readings: dict, limits: dict) -> tuple[bool, list]:
    """(all within their limits, [(name, value, limit)]) for the
    readings {frame: {number: value}} against limits {frame.number:
    limit}; a number without a limit fails."""
    rows = []
    ok = True
    for frame, nums in readings.items():
        for name, value in nums.items():
            key = f"{frame}.{name}"
            limit = limits.get(key)
            good = limit is not None and value <= limit
            ok = ok and good
            rows.append((key, value, limit))
    return ok, rows
