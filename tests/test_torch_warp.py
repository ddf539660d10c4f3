"""Port window warp (plain version) vs the JAX package, on the CPU.

The plain version repeats the JAX reference ``window_warp_ref`` op for op
(the same taps, weights and summation order), so values agree to 1e-6
(float32 ulps of the weight polynomials) and the in-window flags exactly.
The uv wrappers are held against the JAX wrappers, which run the Pallas
kernel in interpret mode here; a narrow window (ky=3) and two channels
keep that interpretation fast.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from realism_effects_tpu.ops.pallas import warp as jw
from realism_effects_tpu_torch.ops import warp as tw
from realism_effects_tpu_torch.ops.cuda_build import launches

H, W = 70, 200  # odd sizes: not multiples of the TPU's 8 x 128 tiles


def _targets(seed):
    """int targets: most near the pixel, some beyond the window, some
    beyond the frame; fractions in [0, 1)."""
    rng = np.random.default_rng(seed)
    ys = np.arange(H)[:, None]
    xs = np.arange(W)[None, :]
    ty = ys + rng.integers(-6, 7, (H, W))
    tx = xs + rng.integers(-25, 26, (H, W))
    far = rng.random((H, W)) < 0.2
    ty = np.where(far, rng.integers(-30, H + 30, (H, W)), ty)
    tx = np.where(far, rng.integers(-300, W + 300, (H, W)), tx)
    fy = rng.random((H, W))
    fx = rng.random((H, W))
    return [a.astype(np.int32) for a in (ty, tx)] + \
        [a.astype(np.float32) for a in (fy, fx)]


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "catrom", "catrom5"])
@pytest.mark.parametrize("kx", [None, 30])
def test_plain_warp_matches_reference(mode, kx):
    rng = np.random.default_rng(1)
    tex = rng.normal(size=(H, W, 4)).astype(np.float32)
    ty, tx, fy, fx = _targets(2)
    got, got_ok = tw.window_warp(*(torch.from_numpy(a) for a in
                                   (tex, ty, tx, fy, fx)),
                                 ky=8, mode=mode, kx=kx)
    want, want_ok = jw.window_warp_ref(*(jnp.asarray(a) for a in
                                         (tex, ty, tx, fy, fx)),
                                       ky=8, mode=mode, kx=kx)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    assert 0.1 < got_ok.numpy().mean() < 0.95  # both kinds of targets


@pytest.mark.parametrize("name,kx", [("catmull_rom5_window", 30),
                                     ("nearest_window", None),
                                     ("bilinear_window", 30),
                                     ("catmull_rom_window", None)])
def test_uv_wrappers_match_jax(name, kx):
    rng = np.random.default_rng(3)
    tex = rng.normal(size=(H, W, 2)).astype(np.float32)
    uv = (np.stack(np.meshgrid((np.arange(W) + 0.5) / W,
                               (np.arange(H) + 0.5) / H), -1)
          + rng.normal(0.0, 0.03, (H, W, 2))).astype(np.float32)
    uv[::7] = rng.uniform(-0.2, 1.2, uv[::7].shape)  # off-frame, off-window
    got, got_ok = getattr(tw, name)(torch.from_numpy(tex),
                                    torch.from_numpy(uv), ky=3, kx=kx)
    want, want_ok = getattr(jw, name)(jnp.asarray(tex), jnp.asarray(uv),
                                      ky=3, kx=kx)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_scalar_texture_and_counter_stays_zero_on_cpu():
    ty, tx, fy, fx = _targets(4)
    tex = np.random.default_rng(5).random((H, W)).astype(np.float32)
    launches.clear()
    got, _ = tw.window_warp(*(torch.from_numpy(a) for a in
                              (tex, ty, tx, fy, fx)), ky=8, mode="catrom5")
    want, _ = jw.window_warp_ref(*(jnp.asarray(a) for a in
                                   (tex, ty, tx, fy, fx)), ky=8,
                                 mode="catrom5")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    assert not launches
