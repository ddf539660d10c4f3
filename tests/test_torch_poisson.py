"""Port Poisson denoise (the fused pass's plain version) vs the JAX
package, on the CPU.

The JAX side runs ``ops/poisson_denoise.py`` as its own tests run it on
the CPU (the jnp formulation, jitted whole to keep the test short); the
port follows the fused kernel's
arithmetic (exp(log(x) * e) powers). The bounds are those
``tests/test_poisson_fused.py`` holds the fused kernel to: 5e-4 for one
pass, 1e-3 for the AO path, 2e-3 for two ping-pong passes.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from realism_effects_tpu.core.framebuffers import GBuffer as JGBuffer
from realism_effects_tpu.ops import poisson_denoise as jpd
from realism_effects_tpu.ops.pallas.poisson import _windows as j_windows
from realism_effects_tpu_torch.core.framebuffers import GBuffer as TGBuffer
from realism_effects_tpu_torch.ops import poisson_denoise as tpd
from realism_effects_tpu_torch.ops import poisson_kernel as tpk
from realism_effects_tpu_torch.ops.cuda_build import launches


def _inputs(h, w, n_tex, seed=0):
    """Noisy depth/normals/roughness with a background band, and rgba
    textures with integer sample counts in alpha."""
    rng = np.random.default_rng(seed)
    depth = np.clip(0.8 + 0.1 * rng.random((h, w)), 0, 1)
    depth[: h // 8] = 1.0
    nrm = rng.uniform(-1, 1, (h, w, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[: h // 8] = 0.0
    planes = dict(
        diffuse=np.zeros((h, w, 4)), normal=nrm, roughness=rng.random((h, w)),
        metalness=np.zeros((h, w)), emissive=np.zeros((h, w, 3)), depth=depth)
    planes = {k: v.astype(np.float32) for k, v in planes.items()}
    texs = [np.concatenate([rng.random((h, w, 3)) * 2.0,
                            rng.integers(0, 40, (h, w, 1))], -1)
            .astype(np.float32) for _ in range(n_tex)]
    jgb = JGBuffer(**{k: jnp.asarray(v) for k, v in planes.items()})
    tgb = TGBuffer(**{k: torch.from_numpy(v) for k, v in planes.items()})
    return texs, jgb, tgb


def _cfgs(**kw):
    return jpd.PoissonDenoiseConfig(**kw), tpd.PoissonDenoiseConfig(**kw)


def test_one_pass_two_textures():
    texs, jgb, tgb = _inputs(96, 160, 2)
    jcfg, tcfg = _cfgs(is_specular=(False, True))
    want = jax.jit(lambda ts, gb: jpd.poisson_denoise_pass(
        ts, gb, jnp.int32(5), jcfg))([jnp.asarray(t) for t in texs], jgb)
    launches.clear()
    got = tpd.poisson_denoise_pass([torch.from_numpy(t) for t in texs], tgb,
                                   5, tcfg)
    assert not launches
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=5e-4,
                                   rtol=5e-4)


def test_ao_scalar_path():
    texs, jgb, tgb = _inputs(64, 128, 1, seed=3)
    ao = np.clip(texs[0][..., 0], 0.0, 1.0)
    jcfg, tcfg = _cfgs()
    want = jax.jit(lambda a, gb: jpd.poisson_denoise_ao(
        a, gb.normal, gb, 5, jcfg))(jnp.asarray(ao), jgb)
    got = tpd.poisson_denoise_ao(torch.from_numpy(ao), tgb.normal, tgb, 5,
                                 tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=1e-3)


def test_two_pass_denoise():
    texs, jgb, tgb = _inputs(64, 128, 2, seed=9)
    jcfg, tcfg = _cfgs(is_specular=(False, True), iterations=1)
    want = jax.jit(lambda ts, gb: jpd.poisson_denoise(ts, gb, 2, jcfg))(
        [jnp.asarray(t) for t in texs], jgb)
    got = tpd.poisson_denoise([torch.from_numpy(t) for t in texs], tgb, 2,
                              tcfg)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=2e-3,
                                   rtol=2e-3)


@pytest.mark.parametrize("h,w,tight", [
    (1080, 1920, None), (1920, 1080, None), (96, 160, None), (64, 64, None),
    (31, 1000, "cols"), (1000, 31, "rows")])
def test_tap_window_clamp_never_binds(h, w, tight):
    """The TPU kernel clamps each tap to +-aky (axis taps) / +-dky
    (diagonal taps) rows and +-kx columns around the pixel
    (`poisson.py:198-200`). At the largest flatness and every angle the
    taps stay inside those windows, so the port's direct frame-clamped
    fetch equals the clamped one. At extreme aspects the windows are
    tight: the farthest tap reaches within one texel of the edge."""
    _, tcfg = _cfgs()
    aky, dky, kx = j_windows(tcfg.radius, h, w)
    rows = torch.tensor([0, 1, h // 3, h // 2, h - 2, h - 1], dtype=torch.int32)
    cols = torch.tensor([0, 1, w // 3, w // 2, w - 2, w - 1], dtype=torch.int32)
    n_ang = 2048
    angle = (torch.arange(n_ang, dtype=torch.float32) / n_ang
             * float(np.float32(2 * math.pi)))
    rr = rows[:, None, None].expand(-1, len(cols), n_ang)
    cc = cols[None, :, None].expand(len(rows), -1, n_ang)
    ang = angle.expand(len(rows), len(cols), n_ang)
    taps = tpk.tap_targets(rr, cc, ang, torch.ones_like(ang), tcfg, h, w)
    reach = []
    for k, (iy, ix) in enumerate(taps):
        dy = (iy - rr).abs().max().item()
        dx = (ix - cc).abs().max().item()
        assert dy <= (aky if k < 4 else dky), (k, dy)
        assert dx <= kx, (k, dx)
        reach.append((dy, dx))
    if tight == "rows":
        assert max(r[0] for r in reach[:4]) >= aky - 1
    if tight == "cols":
        assert max(r[1] for r in reach) >= kx - 1
