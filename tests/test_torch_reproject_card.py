"""Temporal reprojection's kernels in a frame on the card.

Marked ``cuda``: each test skips without a CUDA card. On the card:
``python -m pytest --noconftest -m cuda tests/test_torch_reproject_card.py``
(the repository's conftest imports JAX, which the card's machine lacks).
This file imports no JAX.
"""

import pytest
import torch

from realism_effects_tpu_torch import analytic
from realism_effects_tpu_torch.core.camera import PerspectiveCamera
from realism_effects_tpu_torch.effects import ssgi, traa
from realism_effects_tpu_torch.ops import temporal_reproject
from realism_effects_tpu_torch.ops.cuda_build import launches

pytestmark = pytest.mark.cuda

H, W = 270, 480
FRAMES = 3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return "cuda"


def _run(device, frames):
    """The images and the final state of ``FRAMES`` SSGI + HBAO + TRAA
    frames over ``frames`` (``analytic.frames_at``)."""
    comp, cam = analytic.ssgi_hbao_traa_composer(H, W, device)
    images = analytic.run_frames(comp, cam, frames, range(FRAMES))
    return images, comp._state


def _leaves(state):
    if isinstance(state, dict):
        return [x for k in sorted(state) for x in _leaves(state[k])]
    if isinstance(state, (list, tuple)):
        return [x for v in state for x in _leaves(v)]
    return [state] if torch.is_tensor(state) else []


def test_a_frame_launches_the_kernels_and_equals_the_plain_route(card, monkeypatch):
    """SSGI's two-slot and TRAA's one-slot reprojections each launch the
    prepare and the blend kernel once a frame, and the frames and the
    temporal state equal those of the plain route on the card bit for
    bit."""
    cam = PerspectiveCamera(50, W / H, 0.1, 100)
    frames = analytic.frames_at(cam, range(FRAMES), H, W, card, sphere=True)
    launches.clear()
    got, got_state = _run(card, frames)
    torch.cuda.synchronize()
    assert {k: v for k, v in launches.items() if k.startswith("reproject_")} == {
        "reproject_prepare": 2 * FRAMES, "reproject_1slot": FRAMES,
        "reproject_2slot": FRAMES}

    plain = temporal_reproject.temporal_reproject_plain
    monkeypatch.setattr(ssgi, "temporal_reproject", plain)
    monkeypatch.setattr(traa, "temporal_reproject", plain)
    launches.clear()
    want, want_state = _run(card, frames)
    assert not any(k.startswith("reproject_") for k in launches)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)
    for a, b in zip(_leaves(got_state), _leaves(want_state), strict=True):
        assert torch.equal(a, b)
