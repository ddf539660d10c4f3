"""SSGI's shade kernel in a frame on the card.

Marked ``cuda``: each test skips without a CUDA card. On the card:
``python -m pytest --noconftest -m cuda tests/test_torch_shade_card.py``
(the repository's conftest imports JAX, which the card's machine lacks).
This file imports no JAX.
"""

import pytest
import torch

from realism_effects_tpu_torch import analytic
from realism_effects_tpu_torch.ops import ssgi
from realism_effects_tpu_torch.ops.copy import tree_map
from realism_effects_tpu_torch.ops.cuda_build import launches
from realism_effects_tpu_torch.parallel.sharding import gather_rows, is_blocks, make_mesh

pytestmark = pytest.mark.cuda

H, W = 270, 480
FRAMES = 3
SHARDS = 2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return "cuda"


def _run(make, device, mesh):
    """The images and the final state's tensor leaves (row blocks
    joined) of ``FRAMES`` frames of ``make``'s composer, the camera
    orbiting, through ``render(mesh=mesh)``."""
    comp, cam = make(H, W, device)
    images = []
    for f in range(FRAMES):
        analytic.orbit(cam, f)
        images.append(comp.render(dt=1 / 60, mesh=mesh))
    join = lambda x: gather_rows(x) if is_blocks(x) else x
    leaves = []
    tree_map(lambda x: leaves.append(join(x)), comp._state, is_leaf=is_blocks)
    return [join(x) for x in images], [x for x in leaves if torch.is_tensor(x)]


@pytest.mark.parametrize("make,split", [
    pytest.param(analytic.flagship_composer, False, id="flagship"),
    pytest.param(analytic.flagship_march_composer, False, id="flagship-march"),
    pytest.param(analytic.flagship_composer, True, id="flagship-split"),
    pytest.param(analytic.flagship_march_composer, True, id="flagship-march-split")])
def test_a_pass_launches_the_kernel_once_and_equals_the_plain_route(card, monkeypatch,
                                                                    make, split):
    """SSGI's shade pass launches the shade kernel once a frame (once a
    shard in the split frame, ``SHARDS`` row blocks on the card), in
    either trace mode, and the frames and the temporal state equal those
    of the plain route on the card bit for bit."""
    mesh = make_mesh([card] * SHARDS) if split else None
    launches.clear()
    got, got_state = _run(make, card, mesh)
    torch.cuda.synchronize()
    assert launches["shade"] == FRAMES * (SHARDS if split else 1)

    monkeypatch.setattr(ssgi, "_shade", ssgi._shade_plain)
    launches.clear()
    want, want_state = _run(make, card, mesh)
    assert launches["shade"] == 0
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)
    for a, b in zip(got_state, want_state, strict=True):
        assert torch.equal(a, b)
