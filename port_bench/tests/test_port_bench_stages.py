"""The independent stage references (``reference/stages``) against the
frozen copy at a tiny size: they follow the copy within the cells'
limits, and a fault planted in the copy's glue shows in its stage's
number, which a comparison of the copy with itself could not see."""

import pytest
import torch

from port_bench import check
from port_bench.inputs import Inputs
from port_bench.reference import port as ref_pkg

CELLS = ["hbao_traa-1080p-orbit", "flagship-2160p-orbit-box"]


def _stages(c):
    torch.set_num_threads(1)
    _, records = check.reference_start(c, Inputs(c, 2 ** 31 + 17), "cpu")
    return check.stage_numbers(records)[0]


@pytest.mark.parametrize("cell", CELLS)
def test_stage_references_follow_the_copy(cell, tiny):
    c = tiny(cell)
    nums = _stages(c)
    want = {k.split(".", 1)[1] for k in c.traffic["compare"]["limits"] if k.startswith("stages.")}
    assert set(nums) == want
    ok, rows = check.judge({"stages": nums}, c.traffic["compare"]["limits"])
    assert ok, rows


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


FAULTS = {
    "raster": _scaled_raster,
    "hbao": lambda mp: mp.setattr(ref_pkg.HBAOEffect, "apply", _scaled_apply(ref_pkg.HBAOEffect)),
    "traa": lambda mp: mp.setattr(ref_pkg.TRAAEffect, "apply", _scaled_apply(ref_pkg.TRAAEffect)),
    "motion_blur": lambda mp: mp.setattr(ref_pkg.MotionBlurEffect, "apply",
                                         _scaled_apply(ref_pkg.MotionBlurEffect)),
    "ssgi": lambda mp: mp.setattr(ref_pkg.SSGIEffect, "apply",
                                  _scaled_apply(ref_pkg.SSGIEffect)),
    "ssgi_trace": lambda mp: mp.setattr(ref_pkg.SSGIEffect, "trace", staticmethod(_scaled_trace)),
}


@pytest.mark.parametrize("stage", sorted(FAULTS))
def test_a_fault_in_the_copy_shows_in_its_stage(stage, tiny, monkeypatch):
    c = tiny("flagship-2160p-orbit-box")
    FAULTS[stage](monkeypatch)
    nums = _stages(c)
    limits = c.traffic["compare"]["limits"]
    over = {k for k, v in nums.items() if v > limits[f"stages.{k}"]}
    assert f"{stage}_mean" in over, nums
