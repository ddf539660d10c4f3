"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole run (``run.run_cell``: program, window,
comparison, limits) on the CPU at a tiny size, past the harness's look
for a card, with one fault planted in the program: a stage that returns
its temporal state unchanged, an answer altered where it is produced,
half of the frame left out of a stage. The sound run beside them comes
out correct. (One chip a cell: there is no exchange between chips to
leave out.)"""

import time

import pytest
import torch

import realism_effects_tpu_torch as program
from port_bench import run


def _run(cell):
    torch.set_num_threads(1)
    return run.run_cell(cell, 2 ** 32 + 5, 0.3, False, torch.device("cpu"),
                        time.perf_counter())


def _state_unchanged(monkeypatch, cls):
    apply = cls.apply

    def stale(self, ctx, color, state):
        image, _ = apply(self, ctx, color, state)
        return image, state
    monkeypatch.setattr(cls, "apply", stale)


def _pixel_altered(monkeypatch, cls):
    apply = cls.apply

    def altered(self, ctx, color, state):
        image, new_state = apply(self, ctx, color, state)
        image = image.clone()
        image[image.shape[0] // 2, image.shape[1] // 2] += 0.25
        return image, new_state
    monkeypatch.setattr(cls, "apply", altered)


def _half_left_out(monkeypatch, cls):
    apply = cls.apply

    def half(self, ctx, color, state):
        image, new_state = apply(self, ctx, color, state)
        h = image.shape[0] // 2
        return torch.cat([image[:h], color[h:]]), new_state
    monkeypatch.setattr(cls, "apply", half)


FAULTS = {
    "traa_state_unchanged": ("hbao_traa-1080p-orbit", _state_unchanged, program.TRAAEffect),
    "ssgi_state_unchanged": ("flagship-2160p-orbit-box", _state_unchanged, program.SSGIEffect),
    "traa_pixel_altered": ("hbao_traa-1080p-orbit", _pixel_altered, program.TRAAEffect),
    "motion_blur_pixel_altered": ("flagship-2160p-orbit-box", _pixel_altered,
                                  program.MotionBlurEffect),
    "hbao_half_frame": ("hbao_traa-1080p-orbit", _half_left_out, program.HBAOEffect),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_is_not_correct(fault, tiny, monkeypatch):
    cell_name, plant, cls = FAULTS[fault]
    plant(monkeypatch, cls)
    result = _run(tiny(cell_name))
    assert result["correct"] is False
    assert result["failed"] >= 1
    over = [k for k, row in result["checks"].items() if row["value"] > row["limit"]]
    assert over, result["checks"]


@pytest.mark.parametrize("cell", ["hbao_traa-1080p-orbit", "flagship-2160p-orbit-box"])
def test_a_sound_run_is_correct(cell, tiny):
    result = _run(tiny(cell))
    assert result["correct"] is True, result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 1 and result["failed"] == 0


def test_a_still_camera_steps_exactly(tiny):
    """The reference's step works out the composer's still-camera count
    from the inputs: with the camera still, the program's last frame and
    the reference's step from its state agree bit for bit."""
    cell = tiny("hbao_traa-1080p-orbit")
    cell.traffic["camera"]["params"]["rad_per_frame"] = 0.0
    result = _run(cell)
    assert result["correct"] is True
    assert all(row["value"] == 0.0 for k, row in result["checks"].items()
               if k.startswith("last."))
