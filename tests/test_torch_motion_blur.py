"""The port's motion blur vs the JAX package's, on the CPU.

Inputs: a colour ramp with a bright patch and a velocity field with small
motion, fast motion near the frame edges (cells that fall out of the
frame) and a static block (which must pass through unchanged), at frames
0 and 5 and two frame times.

- ``motion_blur_sweep``: the cell table equals the JAX package's (same
  float32 operations, libm's cosf/sinf/powf); the per-pixel sums run in
  the same cell order, so the result agrees to 1e-5 (measured 4.8e-7;
  transcendental ulps of atan2 could move a pixel to the next direction
  bin, which would show as a large error: at most 0.1% of pixels may).
- ``motion_blur`` (taps): 1e-5 (measured 1.9e-6, bilinear weights of
  float16 texels at uvs an ulp apart).
- ``MotionBlurEffect`` through each package's ``render_external``, the
  frame time from ``dt``: the same bounds, but 1e-4 for the taps, since
  the JAX composer runs jitted and XLA contracts the tap-uv arithmetic:
  an ulp of uv, times 80 texels a unit, times a texel step of up to 4 at
  the bright patch's edge (measured 1.8e-5 at 6 of 3840 pixels).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realism_effects_tpu as jre
from realism_effects_tpu.core.framebuffers import GBuffer as JG
from realism_effects_tpu.core.framebuffers import VelocityBuffer as JV
from realism_effects_tpu.ops import motion_blur as jmb
import realism_effects_tpu_torch as tre
from realism_effects_tpu_torch.ops import motion_blur as tmb

H, W = 48, 80
TOL = 1e-5
JIT_TAPS_TOL = 1e-4
FLIP_FRAC = 1e-3


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    color = np.stack([xx / W, yy / H, 0.5 + 0.3 * np.sin(xx * 0.3)], -1)
    color[10:20, 30:45] = (4.0, 3.0, 2.0)
    vel = rng.normal(0.0, 0.01, (H, W, 2))
    vel[:, :8] = (-0.2, 0.05)        # fast, out of the frame on the left
    vel[-6:, :, 1] = 0.3             # fast, out of the frame at the top
    vel[25:35, 50:70] = 0.0          # static block
    return color.astype(np.float32), vel.astype(np.float32)


def _check(got, want, color, vel, tol=TOL):
    err = np.abs(got - want).max(-1)
    assert (err > tol).mean() <= FLIP_FRAC
    static = (vel * vel).sum(-1) <= 1e-9
    assert static.any()
    np.testing.assert_array_equal(got[static], color[static])
    assert np.abs(got - color).max() > 0.1  # something blurred


@pytest.mark.parametrize("frame,dt", [(0, 1 / 60), (5, 1 / 30)])
def test_motion_blur_sweep_matches_jax(frame, dt):
    color, vel = _inputs(frame)
    want = np.asarray(jmb.motion_blur_sweep(jnp.asarray(color), jnp.asarray(vel),
                                            frame, delta_time=dt))
    got = tmb.motion_blur_sweep(torch.from_numpy(color), torch.from_numpy(vel),
                                frame, delta_time=dt).numpy()
    _check(got, want, color, vel)


@pytest.mark.parametrize("frame,dt", [(0, 1 / 60), (5, 1 / 30)])
def test_motion_blur_taps_matches_jax(frame, dt):
    color, vel = _inputs(frame)
    want = np.asarray(jmb.motion_blur(jnp.asarray(color), jnp.asarray(vel), frame,
                                      delta_time=dt, samples=8))
    got = tmb.motion_blur(torch.from_numpy(color), torch.from_numpy(vel), frame,
                          delta_time=dt, samples=8).numpy()
    _check(got, want, color, vel)


def test_sweep_cells_reach_out_of_frame():
    dys, dxs, e_lo, e_hi, _ = tmb.sweep_cells(3, H, W, 16, 12, 0.75, 0.25)
    assert dys.shape == dxs.shape == (16, 12)
    assert np.abs(dxs).max() > W // 4 - 2 and (e_lo[1:] == e_hi[:-1]).all()


@pytest.mark.parametrize("mode", ["sweep", "taps"])
def test_effect_matches_jax(mode):
    color, vel = _inputs(1)
    zeros = np.zeros((H, W), np.float32)
    depth = np.full((H, W), 0.9, np.float32)
    nrm = np.zeros((H, W, 3), np.float32)
    nrm[..., 1] = 1.0
    gb = dict(diffuse=np.zeros((H, W, 4), np.float32), normal=nrm, roughness=zeros,
              metalness=zeros, emissive=np.zeros((H, W, 3), np.float32), depth=depth)
    jcomp = jre.EffectComposer(jre.Scene(), jre.PerspectiveCamera(50, W / H, 0.1, 100),
                               W, H)
    jcomp.add_effect(jre.MotionBlurEffect(mode=mode, samples=6))
    tcomp = tre.EffectComposer(None, tre.PerspectiveCamera(50, W / H, 0.1, 100), W, H,
                               device="cpu")
    effect = tre.MotionBlurEffect(mode=mode, samples=6)
    tcomp.add_effect(effect)
    for f, dt in enumerate((1 / 45, 1 / 90)):
        want = np.asarray(jcomp.render_external(
            JG(**{k: jnp.asarray(v) for k, v in gb.items()}),
            JV(velocity=jnp.asarray(vel), normal=jnp.asarray(nrm), depth=jnp.asarray(depth)),
            jnp.asarray(color), dt=dt))
        got = tcomp.render_external(
            tre.GBuffer(**{k: torch.from_numpy(v) for k, v in gb.items()}),
            tre.VelocityBuffer(velocity=torch.from_numpy(vel),
                               normal=torch.from_numpy(nrm), depth=torch.from_numpy(depth)),
            torch.from_numpy(color), dt=dt).numpy()
        assert effect.delta_time == dt
        _check(got, want, color, vel, TOL if mode == "sweep" else JIT_TAPS_TOL)
    with pytest.raises(ValueError):
        tre.MotionBlurEffect(mode="roll")
