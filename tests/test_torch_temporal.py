"""Port temporal reprojection vs the JAX package, on the CPU.

Both sides fetch the history with the 5-tap Catmull-Rom window warp and
the disocclusion probe with the nearest window warp (the JAX side runs
its Pallas kernels in interpret mode), so in-window and beyond-window
motion take the same branches. The remaining differences are
transcendental ulps (log/exp of the log transform, the confidence
power) in float32: atol 2e-5 and rtol 5e-5. The alpha channel, the
sample count 1 / (1 - t) - 1, is compared as the blend weight t it was
computed from, since the count magnifies t's ulps by (1 + count)^2 where
t nears 1. The JAX side runs eagerly, as its
own tests do: jitted whole, XLA:CPU's fused transcendentals move it by
up to 1.5e-4 from its own eager result.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from realism_effects_tpu.core.camera import PerspectiveCamera as JCam
from realism_effects_tpu.core.framebuffers import VelocityBuffer as JVel
from realism_effects_tpu.ops import temporal_reproject as jtr
from realism_effects_tpu_torch.core.camera import PerspectiveCamera as TCam
from realism_effects_tpu_torch.core.framebuffers import VelocityBuffer as TVel
from realism_effects_tpu_torch.ops.cuda_build import launches
from realism_effects_tpu_torch.ops import temporal_reproject as ttr

H, W = 64, 96


def _cams(cls, x):
    c = cls(50, W / H, 0.1, 100)
    c.set_position(x, 2.0, 4.0)
    c.look_at((0, 0.5, 0))
    return c.matrices()


def _buffers(seed):
    """Velocity with small motion, motion beyond the +-8 row / +-30 column
    window, and a background band; history with sample counts in alpha."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    vel = rng.normal(0.0, 0.01, (H, W, 2))
    vel[:, : W // 4, 0] = 40.0 / W        # beyond the column window
    vel[H // 2:, W // 2:, 1] = -12.0 / H  # beyond the row window
    depth = 0.9 + 0.05 * np.sin(xx * 0.1) + 0.01 * rng.random((H, W))
    depth[: H // 10] = 1.0
    nrm = np.array([0.0, 0.3, 0.95]) + rng.normal(0, 0.05, (H, W, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[: H // 10] = 0.0
    last_depth = np.clip(depth + rng.normal(0, 0.002, (H, W)), 0, 1)
    color = np.concatenate([rng.random((H, W, 3)) * 1.5,
                            rng.random((H, W, 1)) * 3.0], -1)
    color[::5, ::7, 0] = -1.0  # not sampled this frame
    history = np.concatenate([rng.random((H, W, 3)),
                              rng.integers(0, 30, (H, W, 1))], -1)
    f = lambda a: np.asarray(a, np.float32)
    return (f(vel), f(nrm), f(depth), f(last_depth), f(color), f(history))


@pytest.mark.parametrize("case", ["traa", "specular_dilated"])
def test_temporal_reproject_matches_jax(case):
    vel, nrm, depth, last_depth, color, history = _buffers(7)
    if case == "traa":
        kw = dict(texture_count=1, log_transform=True, confidence_power=4.0)
        inputs, hist = [color], [history]
        call = dict(max_blend=0.9, neighborhood_clamp_intensity=1.0,
                    full_accumulate=False, keep_data=1.0)
    else:
        kw = dict(texture_count=2, input_type="diffuse_specular",
                  reproject_specular=(False, True), dilation=True)
        spec = color.copy()
        spec[..., 3] = np.abs(spec[..., 3]) + 0.5   # ray length
        inputs, hist = [color, spec], [history, history[::-1].copy()]
        call = dict(max_blend=0.95, neighborhood_clamp_intensity=0.5,
                    full_accumulate=False, keep_data=1.0)
    jcfg = jtr.TemporalReprojectConfig(**kw)
    tcfg = ttr.TemporalReprojectConfig(**kw)

    jv = JVel(velocity=jnp.asarray(vel), normal=jnp.asarray(nrm),
              depth=jnp.asarray(depth))
    jlv = JVel(velocity=jnp.asarray(vel), normal=jnp.asarray(nrm),
               depth=jnp.asarray(last_depth))
    want = jtr.temporal_reproject(
        [jnp.asarray(a) for a in inputs], [jnp.asarray(a) for a in hist],
        jv, jlv, _cams(JCam, 0.5), _cams(JCam, 0.45), jcfg, **call)

    t = torch.from_numpy
    tv = TVel(velocity=t(vel), normal=t(nrm), depth=t(depth))
    tlv = TVel(velocity=t(vel), normal=t(nrm), depth=t(last_depth))
    launches.clear()
    got = ttr.temporal_reproject(
        [t(a) for a in inputs], [t(a) for a in hist], tv, tlv,
        _cams(TCam, 0.5), _cams(TCam, 0.45), tcfg, **call)
    assert not launches   # the CPU route launches no kernel
    for g, w_ in zip(got, want):
        g, w_ = g.numpy(), np.asarray(w_)
        np.testing.assert_allclose(g[..., :3], w_[..., :3], rtol=5e-5,
                                   atol=2e-5)
        # alpha a = 1 / (1 - t) - 1 has derivative (1 + a)^2 in the blend
        # weight t, so it magnifies t's float32 error where t nears 1: at
        # a = 2.17 (t = 0.68) the two sides differ by 1.6e-4 in a but by
        # 1.6e-5 in t, and each side's t is 3.2e-5 from a float64 run of
        # the same formula. Compare a as t = a / (1 + a), the quantity
        # both sides computed, at the same tolerance.
        blend = lambda a: a / (1.0 + a)
        np.testing.assert_allclose(blend(g[..., 3]), blend(w_[..., 3]),
                                   rtol=5e-5, atol=2e-5)
    # both branches taken: some pixels keep history, some were reset
    alpha = got[0][..., 3].numpy()
    assert (alpha > 1.5).any() and (alpha < 1e-3).any()
