"""The independent stage references (``reference/stages``) against the
frozen copy at a tiny size: they follow the copy within the cells'
limits, and a fault planted in the copy's glue shows in its stage's
number, which a comparison of the copy with itself could not see. Two
stacks that no cell registers yet are held to their references under
the limits sized for them on the card: the flagship with SSGI's march
and motion blur's taps, and SSR -> GTAO -> TAA over HBAO + TRAA's
traffic, its camera orbiting and, so that TAA blends, standing still."""

import dataclasses

import pytest
import torch

from port_bench import check
from port_bench.inputs import Inputs
from port_bench.reference import port as ref_pkg
from port_bench.reference.port.ops import motion_blur as copy_motion_blur
from port_bench.reference.port.ops import ssgi as copy_ssgi

#: the registered cells, each in its own modes, and the stacks no cell
#: registers yet, as ``<cell>+<change>...`` (:data:`CHANGES`)
CELLS = ["hbao_traa-1080p-orbit", "flagship-1080p-orbit", "flagship-2160p-orbit-box",
         "flagship-2160p-orbit-box+march_taps", "hbao_traa-1080p-orbit+ssr_gtao_taa",
         "hbao_traa-1080p-orbit+ssr_gtao_taa+still"]

#: the limits of the march and taps references' numbers, sized at 1920
#: x 1080 on the card between the copy's largest reading over seven
#: seeds (1.44e-6; 0.0) and the bfloat16 control's smallest (1.31e-3;
#: 1.48e-3); PERF.md section 2
MARCH_TAPS_LIMITS = {"stages.ssgi_trace_march_mean": 5e-5,
                     "stages.motion_blur_taps_mean": 2e-5}

#: the limits of the SSR, GTAO and TAA references' numbers, sized at
#: 1920 x 1080 on the card between the copy's largest reading over 18
#: seeds of the orbit and of a still camera (3.65e-6, 9.35e-7, 2.53e-6,
#: 0.0) and the bfloat16 control's smallest over 14 (1.22e-3, 1.21e-3,
#: 1.11e-3; TAA's 1.08e-3 on the still camera: on the orbit it passes its
#: input through and reads 0.0 on both sides); PERF.md section 2
SSR_GTAO_TAA_LIMITS = {"stages.ssr_trace_mean": 1e-4,
                       "stages.ssr_mean": 5e-5,
                       "stages.gtao_mean": 1e-4,
                       "stages.taa_mean": 2e-5}


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


def ssr_gtao_taa(c):
    """HBAO + TRAA's cell ``c`` with the stack ``SSREffect`` ->
    ``GTAOEffect`` -> ``TAAPass`` at their defaults, and the HBAO and
    TRAA stages' limits swapped for theirs."""
    c.config["stack"] = [{"effect": e, "options": {}}
                         for e in ("SSREffect", "GTAOEffect", "TAAPass")]
    limits = c.traffic["compare"]["limits"]
    del limits["stages.hbao_mean"], limits["stages.traa_mean"]
    limits.update(SSR_GTAO_TAA_LIMITS)
    return c


def _still(c):
    """The cell ``c`` with its camera standing still."""
    c.traffic["camera"]["params"]["rad_per_frame"] = 0.0
    return c


CHANGES = {"march_taps": _march_taps, "ssr_gtao_taa": ssr_gtao_taa, "still": _still}


def _cell(spec: str, tiny):
    name, *changes = spec.split("+")
    c = tiny(name)
    for change in changes:
        CHANGES[change](c)
    return c


def _records(c):
    torch.set_num_threads(1)
    return check.reference_start(c, Inputs(c, 2 ** 31 + 17), "cpu")[1]


@pytest.fixture(scope="module")
def records_of(tiny):
    """``records_of(cell)``: :func:`_records` of a :data:`CELLS` entry,
    made once a module for the tests that only read them."""
    made = {}

    def get(cell):
        if cell not in made:
            made[cell] = _records(_cell(cell, tiny))
        return made[cell]
    return get


@pytest.mark.parametrize("cell", CELLS)
def test_stage_references_follow_the_copy(cell, tiny, records_of):
    """Each stage is held to the reference of its mode, and a cell gives
    exactly the numbers it has limits for."""
    c = _cell(cell, tiny)
    nums = check.stage_numbers(records_of(cell))[0]
    want = {k.split(".", 1)[1] for k in c.traffic["compare"]["limits"] if k.startswith("stages.")}
    assert set(nums) == want
    ok, rows = check.judge({"stages": nums}, c.traffic["compare"]["limits"])
    assert ok, rows


#: the stages whose algorithm is a mode, each with a cell that runs it
MODE_CELLS = {"ssgi_trace": "flagship-2160p-orbit-box",
              "motion_blur": "flagship-2160p-orbit-box",
              "ssr_trace": "hbao_traa-1080p-orbit+ssr_gtao_taa"}


@pytest.mark.parametrize("stage", sorted(MODE_CELLS))
def test_a_mode_without_a_reference_stops_the_check(stage, records_of):
    records = dict(records_of(MODE_CELLS[stage]))
    records[stage] = dict(records[stage], mode="unwritten")
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
    "gtao": lambda mp: mp.setattr(ref_pkg.GTAOEffect, "apply", _scaled_apply(ref_pkg.GTAOEffect)),
    "ssr": lambda mp: mp.setattr(ref_pkg.SSREffect, "apply", _scaled_apply(ref_pkg.SSREffect)),
    "ssr_trace": lambda mp: mp.setattr(ref_pkg.SSREffect, "trace", staticmethod(_scaled_trace)),
    "taa": lambda mp: mp.setattr(ref_pkg.TAAPass, "apply", _scaled_apply(ref_pkg.TAAPass)),
}

#: the cell each fault is planted in, where it is not the 4K flagship's
FAULT_CELLS = {"ssgi_trace_march": "flagship-2160p-orbit-box+march_taps",
               "motion_blur_taps": "flagship-2160p-orbit-box+march_taps",
               **{s: "hbao_traa-1080p-orbit+ssr_gtao_taa"
                  for s in ("gtao", "ssr", "ssr_trace", "taa")}}


@pytest.mark.parametrize("stage", sorted(FAULTS))
def test_a_fault_in_the_copy_shows_in_its_stage(stage, tiny, monkeypatch):
    c = _cell(FAULT_CELLS.get(stage, "flagship-2160p-orbit-box"), tiny)
    FAULTS[stage](monkeypatch)
    nums = check.stage_numbers(_records(c))[0]
    limits = c.traffic["compare"]["limits"]
    over = {k for k, v in nums.items() if v > limits[f"stages.{k}"]}
    assert f"{stage}_mean" in over, nums
