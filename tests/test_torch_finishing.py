"""Port finishing effects vs the JAX package, on the CPU.

- ``sharpness_3x3_plain`` against the JAX ``sharpness_3x3`` (its Pallas
  kernel in interpret mode here), every row and column: bit for bit. The
  plain version sums in the kernel's order and contracts its two
  multiply-adds as XLA's CPU code does (any other order: 2.4e-7 on a
  sixth of the pixels).
- Each effect's ``apply`` against the JAX one on the same inputs, at
  ``tests/test_finishing_parity.py``'s tolerances: 2e-5 (sharpness, lens
  distortion), 5e-5 (gradual background), and for sparkle, whose
  500th-power noise magnifies the float32 ulps of its trig hash, the
  99th percentile under 1e-3 and under 2% of pixels off by more than
  0.05. Measured here: all four bit-identical.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from realism_effects_tpu.composer import FrameContext as JCtx
from realism_effects_tpu.core.camera import PerspectiveCamera as JCam
from realism_effects_tpu.core.framebuffers import GBuffer as JGB
from realism_effects_tpu.core.framebuffers import VelocityBuffer as JVel
from realism_effects_tpu.effects import finishing as jf
from realism_effects_tpu.ops.pallas.stencil import sharpness_3x3 as j_sharp
from realism_effects_tpu_torch.composer import FrameContext as TCtx
from realism_effects_tpu_torch.core.camera import PerspectiveCamera as TCam
from realism_effects_tpu_torch.core.framebuffers import GBuffer as TGB
from realism_effects_tpu_torch.core.framebuffers import VelocityBuffer as TVel
from realism_effects_tpu_torch.effects import finishing as tf
from realism_effects_tpu_torch.ops import stencil
from realism_effects_tpu_torch.ops.cuda_build import launches

H, W = 40, 56


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape,s", [((200, 256, 3), 1.0), ((97, 128, 3), 0.75),
                                     ((97, 128, 3), 1.7)])
def test_sharpness_plain_matches_pallas_kernel(shape, s):
    rng = np.random.default_rng(shape[0])
    color = rng.uniform(0.0, 2.0, shape).astype(np.float32)
    color[5, 7] = 0.0    # clamps at 0 around a dark texel
    launches.clear()
    got = stencil.sharpness_3x3(torch.from_numpy(color), s).numpy()
    assert not launches
    np.testing.assert_array_equal(got, np.asarray(j_sharp(jnp.asarray(color), s)))


def _inputs(seed):
    """Colour, G-buffer, velocity and camera matrices on both sides."""
    rng = np.random.default_rng(seed)
    color = rng.uniform(0.0, 1.5, (H, W, 3)).astype(np.float32)
    nrm = rng.uniform(-1, 1, (H, W, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)
    depth = rng.uniform(0.3, 0.95, (H, W)).astype(np.float32)
    depth[:2] = 1.0
    planes = dict(diffuse=np.zeros((H, W, 4), np.float32), normal=nrm,
                  roughness=np.ones((H, W), np.float32),
                  metalness=np.zeros((H, W), np.float32),
                  emissive=np.zeros((H, W, 3), np.float32), depth=depth)
    vel = dict(velocity=np.zeros((H, W, 2), np.float32), normal=nrm, depth=depth)
    cams = []
    for cls in (JCam, TCam):
        c = cls(50, W / H, 0.1, 60)
        c.set_position(1.5, 2.5, 4)
        c.look_at((0, 0.5, 0))
        cams.append(c.matrices())
    return color, planes, vel, cams


def _run(effect_name, uniforms, seed=0, **kw):
    color, planes, vel, (jm, tm) = _inputs(seed)
    jeff, teff = getattr(jf, effect_name)(**kw), getattr(tf, effect_name)(**kw)
    jgb = JGB(**{k: jnp.asarray(v) for k, v in planes.items()})
    jv = JVel(**{k: jnp.asarray(v) for k, v in vel.items()})
    jctx = JCtx(gbuffer=jgb, velocity=jv, last_velocity=jv, scene_color=None,
                cam=jm, unjittered_cam=jm, prev_cam=jm, frame_index=jnp.int32(0),
                params={jeff.name: {k: jnp.float32(v) for k, v in uniforms.items()},
                        "__global__": {}}, env=None)
    tgb = TGB(**{k: torch.from_numpy(v) for k, v in planes.items()})
    tv = TVel(**{k: torch.from_numpy(v) for k, v in vel.items()})
    tctx = TCtx(gbuffer=tgb, velocity=tv, last_velocity=tv, scene_color=None,
                cam=tm, unjittered_cam=tm, prev_cam=tm, frame_index=0,
                params={teff.name: dict(uniforms), "__global__": {}})
    want, _ = jeff.apply(jctx, jnp.asarray(color), {})
    got, _ = teff.apply(tctx, torch.from_numpy(color), {})
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("name,uniforms,kw,tol", [
    ("SharpnessEffect", {"sharpness": 1.7}, {"sharpness": 1.7}, 2e-5),
    ("LensDistortionEffect", {"alpha_x": -0.07, "alpha_y": -0.04, "aberration": 1.5},
     {"alpha_x": -0.07, "alpha_y": -0.04, "aberration": 1.5}, 2e-5),
    ("GradualBackgroundEffect", {"max_distance": 5.0},
     {"background_color": (0.1, 0.2, 0.3), "max_distance": 5.0}, 5e-5),
])
def test_effect_matches_jax(name, uniforms, kw, tol):
    got, want = _run(name, uniforms, **kw)
    assert got.shape == want.shape == (H, W, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_sparkle_matches_jax():
    got, want = _run("SparkleEffect", {"spread": 1.0, "intensity": 2.0},
                     spread=1.0, intensity=2.0)
    d = np.abs(got - want)
    assert np.isfinite(got).all()
    assert np.quantile(d, 0.99) < 1e-3, float(np.quantile(d, 0.99))
    assert (d.max(-1) > 0.05).mean() < 0.02
