"""The independent stage references (``reference/stages``) against the
frozen copy at a tiny size: they follow the copy within the cells'
limits, and a fault planted in the copy's glue shows in its stage's
number, which a comparison of the copy with itself could not see. The
flagship stack with SSGI's march and motion blur's taps, which no cell
registers yet, is held to the references of those modes under the
limits sized for them on the card."""

import dataclasses

import pytest
import torch

from port_bench import check
from port_bench.inputs import Inputs
from port_bench.reference import port as ref_pkg
from port_bench.reference.port.ops import motion_blur as copy_motion_blur
from port_bench.reference.port.ops import ssgi as copy_ssgi

#: the registered cells, each in its own modes, and the flagship with
#: SSGI's march and motion blur's taps (``+march_taps``)
CELLS = ["hbao_traa-1080p-orbit", "flagship-1080p-orbit", "flagship-2160p-orbit-box",
         "flagship-2160p-orbit-box+march_taps"]

#: the limits of the march and taps references' numbers, sized at 1920
#: x 1080 on the card between the copy's largest reading over seven
#: seeds (1.44e-6; 0.0) and the bfloat16 control's smallest (1.31e-3;
#: 1.48e-3); PERF.md section 2
MARCH_TAPS_LIMITS = {"stages.ssgi_trace_march_mean": 5e-5,
                     "stages.motion_blur_taps_mean": 2e-5}


def _march_taps(c):
    """The cell ``c`` with SSGI tracing by the march and motion blur in
    taps mode, and its sweep stages' limits swapped for theirs."""
    modes = {"SSGIEffect": ("trace", "march"), "MotionBlurEffect": ("mode", "taps")}
    for e in c.config["stack"]:
        if e["effect"] in modes:
            key, mode = modes[e["effect"]]
            e["options"][key] = mode
    limits = c.traffic["compare"]["limits"]
    del limits["stages.ssgi_trace_mean"], limits["stages.motion_blur_mean"]
    limits.update(MARCH_TAPS_LIMITS)
    return c


def _stages(c):
    torch.set_num_threads(1)
    _, records = check.reference_start(c, Inputs(c, 2 ** 31 + 17), "cpu")
    return check.stage_numbers(records)[0]


@pytest.mark.parametrize("cell", CELLS)
def test_stage_references_follow_the_copy(cell, tiny):
    """Each stage is held to the reference of its mode, and a cell gives
    exactly the numbers it has limits for."""
    name, _, modes = cell.partition("+")
    c = _march_taps(tiny(name)) if modes else tiny(name)
    nums = _stages(c)
    want = {k.split(".", 1)[1] for k in c.traffic["compare"]["limits"] if k.startswith("stages.")}
    assert set(nums) == want
    ok, rows = check.judge({"stages": nums}, c.traffic["compare"]["limits"])
    assert ok, rows


@pytest.mark.parametrize("stage", ["ssgi_trace", "motion_blur"])
def test_a_mode_without_a_reference_stops_the_check(stage, tiny):
    c = tiny("flagship-2160p-orbit-box")
    torch.set_num_threads(1)
    _, records = check.reference_start(c, Inputs(c, 3), "cpu")
    records[stage]["mode"] = "unwritten"
    with pytest.raises(LookupError, match=f"{stage}.*unwritten"):
        check.stage_numbers(records)


def _scaled_apply(cls):
    apply = cls.apply

    def scaled(self, ctx, color, state):
        image, new_state = apply(self, ctx, color, state)
        return image * 1.001, new_state
    return scaled


def _scaled_trace(*a, _trace=ref_pkg.SSGIEffect.trace, **k):
    g_diffuse, g_specular = _trace(*a, **k)
    return g_diffuse, torch.cat([g_specular[..., :3] * 1.001, g_specular[..., 3:]], -1)


def _scaled_raster(mp):
    def wrap(init):
        def patched(self, *a, **k):
            init(self, *a, **k)
            raster = self._raster

            def scaled(*a, **k):
                out = raster(*a, **k)
                return (out[0], out[1], out[2] * 1.001, *out[3:])
            self._raster = scaled
        return patched
    mp.setattr(ref_pkg.EffectComposer, "__init__", wrap(ref_pkg.EffectComposer.__init__))


def _march_unrefined(mp):
    """The copy's march with its bisections left out."""
    march = copy_ssgi.view_space_ray_march

    def unrefined(*a):
        *args, cfg = a
        return march(*args, dataclasses.replace(cfg, refine_steps=0))
    unrefined.calls = 0
    mp.setattr(copy_ssgi, "view_space_ray_march", unrefined)


def _scaled_taps(mp):
    taps = copy_motion_blur.motion_blur
    mp.setattr(copy_motion_blur, "motion_blur", lambda *a, **k: taps(*a, **k) * 1.001)


FAULTS = {
    "raster": _scaled_raster,
    "hbao": lambda mp: mp.setattr(ref_pkg.HBAOEffect, "apply", _scaled_apply(ref_pkg.HBAOEffect)),
    "traa": lambda mp: mp.setattr(ref_pkg.TRAAEffect, "apply", _scaled_apply(ref_pkg.TRAAEffect)),
    "motion_blur": lambda mp: mp.setattr(ref_pkg.MotionBlurEffect, "apply",
                                         _scaled_apply(ref_pkg.MotionBlurEffect)),
    "ssgi": lambda mp: mp.setattr(ref_pkg.SSGIEffect, "apply",
                                  _scaled_apply(ref_pkg.SSGIEffect)),
    "ssgi_trace": lambda mp: mp.setattr(ref_pkg.SSGIEffect, "trace", staticmethod(_scaled_trace)),
    "ssgi_trace_march": _march_unrefined,
    "motion_blur_taps": _scaled_taps,
}


@pytest.mark.parametrize("stage", sorted(FAULTS))
def test_a_fault_in_the_copy_shows_in_its_stage(stage, tiny, monkeypatch):
    c = tiny("flagship-2160p-orbit-box")
    if stage in ("ssgi_trace_march", "motion_blur_taps"):
        _march_taps(c)
    FAULTS[stage](monkeypatch)
    nums = _stages(c)
    limits = c.traffic["compare"]["limits"]
    over = {k for k, v in nums.items() if v > limits[f"stages.{k}"]}
    assert f"{stage}_mean" in over, nums
