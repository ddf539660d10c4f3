"""Port HBAO vs the JAX package, on the CPU.

The JAX side runs ``ops.ao.hbao`` as its own tests run it on the CPU (the
jnp formulation with the interpret-mode window fetch); the port runs the
fused kernel's plain version. The two differ in transcendental ulps
(rsqrt against x/|x|, exp(log(u) * e) against pow), so the bound is the
one ``tests/test_ao_fused.py`` holds the fused kernel to: atol 2e-4,
rtol 1e-4.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from realism_effects_tpu.core.camera import PerspectiveCamera as JCam
from realism_effects_tpu.ops import ao as jao
from realism_effects_tpu.ops.pallas.hbao import rolled_noise_tiles as j_tiles
from realism_effects_tpu_torch.core.camera import PerspectiveCamera as TCam
from realism_effects_tpu_torch.ops import ao as tao
from realism_effects_tpu_torch.ops import hbao_kernel as thk
from realism_effects_tpu_torch.ops.cuda_build import launches


def _scene(h, w, seed=11):
    """Piecewise-smooth depth with an edge, a background band (depth 1,
    zero normals) and jittered normals; the test_ao_fused.py scene."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    depth = 0.85 + 0.1 * (xx > w // 2) + 0.002 * np.sin(yy * 0.2)
    depth[: h // 8] = 1.0
    nrm = np.array([0.1, 0.2, 0.97]) + rng.uniform(-0.1, 0.1, (h, w, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[: h // 8] = 0.0
    cams = []
    for cls in (JCam, TCam):
        c = cls(50, w / h, 0.1, 80)
        c.set_position(0.3, 1.5, 5.0)
        c.look_at((0, 0.5, 0))
        cams.append(c.matrices())
    return depth.astype(np.float32), nrm.astype(np.float32), cams


@pytest.mark.parametrize("frame,distance", [(3, 0.3), (0, 2.0)])
def test_hbao_matches_jax(frame, distance):
    h, w = 96, 160
    depth, nrm, (jcam, tcam) = _scene(h, w)
    jcfg = jao.AOConfig(spp=8, distance=distance)
    tcfg = tao.AOConfig(spp=8, distance=distance)
    _, want = jao.hbao(jnp.asarray(depth), jnp.asarray(nrm), jcam, frame, jcfg)
    launches.clear()
    _, got = tao.hbao(torch.from_numpy(depth), torch.from_numpy(nrm), tcam,
                      frame, tcfg)
    assert not launches
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-4)
    assert (got.numpy()[: h // 8] == 1.0).all()  # background discard
    assert got.numpy().min() < 0.9               # some occlusion


def test_noise_tiles_match_jax():
    got = thk.rolled_noise_tiles(4, 7, True).numpy()
    want = np.asarray(j_tiles(4, 7, True))
    np.testing.assert_array_equal(got, want)


def test_depth_world_normals_match_jax():
    h, w = 48, 80
    depth, _, (jcam, tcam) = _scene(h, w, seed=4)
    depth = depth - 0.01 * np.cos(np.arange(w) * 0.3)[None, :].astype(np.float32)
    got = tao.depth_world_normals(torch.from_numpy(depth), tcam).numpy()
    want = np.asarray(jao.depth_world_normals(jnp.asarray(depth), jcam))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
