"""The traffic generator: a seed fixes the inputs, and only the motions'
free parameters depend on it."""

import numpy as np
import pytest

from port_bench.inputs import Inputs
from port_bench.manifest import resolve

SEEDS = (0, 2 ** 31 + 12345, 3 * 2 ** 32 + 7, -5)


def _frames(inputs, n=5):
    return ([inputs.camera(f) for f in range(n)],
            [inputs.objects(f) for f in range(n)])


@pytest.mark.parametrize("cell", ["flagship-1080p-orbit", "flagship-2160p-orbit-box"])
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_inputs(cell, seed):
    c = resolve(cell)
    a, b = Inputs(c, seed), Inputs(c, seed)
    cams_a, objs_a = _frames(a)
    cams_b, objs_b = _frames(b)
    assert cams_a == cams_b
    for x, y in zip(objs_a, objs_b):
        assert x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
    assert np.array_equal(a.scene["sky"], b.scene["sky"])


@pytest.mark.parametrize("cell", ["flagship-1080p-orbit", "flagship-2160p-orbit-box"])
def test_seeds_differ_only_in_motion(cell):
    c = resolve(cell)
    a, b = Inputs(c, SEEDS[1]), Inputs(c, SEEDS[2])
    assert a.camera(0) != b.camera(0)
    if c.traffic["objects"]:
        assert not np.array_equal(a.objects(0)["box"], b.objects(0)["box"])
    assert (a.width, a.height, a.warmup) == (b.width, b.height, b.warmup)
    for ma, mb in zip(a.scene["meshes"], b.scene["meshes"]):
        assert np.array_equal(ma["faces"], mb["faces"])
    # the orbit keeps its radius, height and step whatever the seed
    for inp in (a, b):
        (x0, y0, z0), _ = inp.camera(0)
        (x1, _, z1), _ = inp.camera(1)
        assert np.isclose(np.hypot(x0, z0), 4.0) and y0 == 2.5
        assert np.isclose(np.hypot(x1 - x0, z1 - z0), 2 * 4.0 * np.sin(0.005))


def test_scene_is_the_flagships():
    scene = Inputs(resolve("flagship-1080p-orbit"), 1).scene
    assert sum(len(m["faces"]) for m in scene["meshes"]) == 734
    assert scene["sky"].shape == (64, 128, 3) and scene["sky"].dtype == np.float32
