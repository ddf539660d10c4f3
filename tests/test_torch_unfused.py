"""The port's unfused HBAO + Poisson route vs the JAX package, on the CPU.

On the CPU the JAX package always runs HBAO and the Poisson denoiser
unfused: HBAO's spp depth taps through ``window_warp_multi`` and each
denoise pass's 8 taps through ``poisson_taps_dense`` (both Pallas kernels
in interpret mode). The port runs the same formulations with
``ops.ao.USE_FUSED_KERNEL`` and ``ops.poisson_kernel.USE_FUSED_PASS``
off (``analytic.unfused()``).

- ``window_warp_multi_plain`` and ``poisson_taps_plain`` against the
  Pallas kernels: bit for bit (nearest fetches).
- Unfused HBAO on ``tests/test_torch_hbao.py``'s scene: max 1e-5
  (measured 4.2e-6; the fused comparison's bound is 2e-4).
- The unfused Poisson pass at ``tests/test_torch_poisson.py``'s bounds:
  5e-4 for one pass of 1, 2 and 3 textures (measured 2.3e-4 on a few
  pixels of values up to 2, mean 8e-8: XLA's pow and exp against
  ATen's), 1e-3 for the AO path (measured 4.8e-7).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from realism_effects_tpu.ops import ao as jao
from realism_effects_tpu.ops import poisson_denoise as jpd
from realism_effects_tpu.ops.pallas import warp as jw
from realism_effects_tpu.ops.pallas.poisson_taps import (dense_windows,
                                                        poisson_taps_dense)
from realism_effects_tpu_torch import analytic
from realism_effects_tpu_torch.ops import ao as tao
from realism_effects_tpu_torch.ops import (poisson_denoise, poisson_kernel,
                                           poisson_taps, warp)
from realism_effects_tpu_torch.ops.cuda_build import launches

from test_torch_hbao import _scene as _hbao_scene
from test_torch_poisson import _cfgs, _inputs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("kx", [None, 32])
def test_window_warp_multi_matches_jax(c, kx):
    """``tests/test_warp.py``'s multi-target setup: rows within +-7,
    columns within +-140 of the pixel, window ky = 4."""
    rng = np.random.default_rng(23 + c)
    h, w, n, ky = 100, 200, 5, 4
    tex = rng.standard_normal((h, w) if c == 1 else (h, w, c)).astype(np.float32)
    ty = (np.arange(h)[None, :, None] + rng.integers(-7, 8, (n, h, w))).astype(np.int32)
    tx = (np.arange(w)[None, None, :] + rng.integers(-140, 141, (n, h, w))).astype(np.int32)
    want, want_ok = jw.window_warp_multi(jnp.asarray(tex), jnp.asarray(ty),
                                         jnp.asarray(tx), ky=ky, kx=kx)
    launches.clear()
    got, ok = warp.window_warp_multi(torch.from_numpy(tex), torch.from_numpy(ty),
                                     torch.from_numpy(tx), ky=ky, kx=kx)
    assert not launches
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    assert not ok.numpy().all() and ok.numpy().any()


def test_nearest_window_multi_matches_jax():
    """The uv wrapper: 3 targets a pixel within and beyond a +-6-row,
    +-20-column window, uvs slightly outside [0, 1] included."""
    rng = np.random.default_rng(7)
    h, w, n = 48, 80, 3
    tex = rng.standard_normal((h, w, 2)).astype(np.float32)
    uvs = (np.stack(np.meshgrid((np.arange(w) + 0.5) / w, (np.arange(h) + 0.5) / h),
                    -1)[None] + rng.uniform(-0.3, 0.3, (n, h, w, 2))).astype(np.float32)
    want, want_ok = jw.nearest_window_multi(jnp.asarray(tex), jnp.asarray(uvs), ky=6, kx=20)
    got, ok = warp.nearest_window_multi(torch.from_numpy(tex), torch.from_numpy(uvs),
                                        ky=6, kx=20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))


@pytest.mark.parametrize("c", [5, 7])
def test_poisson_taps_match_jax(c):
    """Targets anywhere inside the dense windows of radius 3 (axis taps
    first, then diagonal taps), clamped into the frame."""
    rng = np.random.default_rng(c)
    h, w = 96, 160
    (aky, akx), (dky, dkx) = dense_windows(3.0, h, w)
    bundle = rng.standard_normal((h, w, c)).astype(np.float32)
    ys = np.arange(h)[None, :, None]
    xs = np.arange(w)[None, None, :]
    lim_y = np.array([aky] * 4 + [dky] * 4)[:, None, None]
    lim_x = np.array([akx] * 4 + [dkx] * 4)[:, None, None]
    iy = np.clip(ys + np.round(rng.uniform(-1, 1, (8, h, w)) * lim_y), 0, h - 1)
    ix = np.clip(xs + np.round(rng.uniform(-1, 1, (8, h, w)) * lim_x), 0, w - 1)
    iy, ix = iy.astype(np.int32), ix.astype(np.int32)
    want = poisson_taps_dense(jnp.asarray(bundle), jnp.asarray(iy),
                              jnp.asarray(ix), ((aky, akx), (dky, dkx)))
    got = poisson_taps.poisson_taps(torch.from_numpy(bundle), torch.from_numpy(iy),
                                    torch.from_numpy(ix))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("frame,distance", [(3, 0.3), (0, 2.0)])
def test_unfused_hbao_matches_jax(frame, distance):
    h, w = 96, 160
    depth, nrm, (jcam, tcam) = _hbao_scene(h, w)
    _, want = jao.hbao(jnp.asarray(depth), jnp.asarray(nrm), jcam, frame,
                       jao.AOConfig(spp=8, distance=distance))
    with analytic.unfused():
        _, got = tao.hbao(torch.from_numpy(depth), torch.from_numpy(nrm), tcam,
                          frame, tao.AOConfig(spp=8, distance=distance))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert (got.numpy()[: h // 8] == 1.0).all() and got.numpy().min() < 0.9


@pytest.mark.parametrize("n_tex", [1, 2, 3])
def test_unfused_poisson_pass_matches_jax(n_tex):
    """1 and 2 textures ride the packed bundle (5 and 7 slots); 3 take
    the JAX package's separate fetches of normal/depth/roughness and of
    each texture."""
    texs, jgb, tgb = _inputs(96, 160, n_tex)
    jcfg, tcfg = _cfgs(is_specular=(False, True, False)[:n_tex])
    want = jax.jit(lambda ts, gb: jpd.poisson_denoise_pass(
        ts, gb, jnp.int32(5), jcfg))([jnp.asarray(t) for t in texs], jgb)
    with analytic.unfused():
        got = poisson_denoise.poisson_denoise_pass(
            [torch.from_numpy(t) for t in texs], tgb, 5, tcfg)
    assert len(got) == n_tex
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=5e-4, rtol=5e-4)


def test_unfused_ao_path_matches_jax():
    texs, jgb, tgb = _inputs(64, 128, 1, seed=3)
    ao = np.clip(texs[0][..., 0], 0.0, 1.0)
    jcfg, tcfg = _cfgs()
    want = jax.jit(lambda a, gb: jpd.poisson_denoise_ao(
        a, gb.normal, gb, 5, jcfg))(jnp.asarray(ao), jgb)
    with analytic.unfused():
        got = poisson_denoise.poisson_denoise_ao(torch.from_numpy(ao), tgb.normal,
                                                 tgb, 5, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=1e-3)


def test_fused_route_stays_the_default(monkeypatch):
    """The switches default to the fused kernels, ``unfused()`` turns both
    off and restores them, and each route calls its own functions."""
    assert tao.USE_FUSED_KERNEL and poisson_kernel.USE_FUSED_PASS
    calls = []
    for mod, name in ((tao, "hbao_fused"), (tao, "hbao_unfused"),
                      (poisson_denoise, "poisson_pass_fused"),
                      (poisson_denoise, "poisson_pass_unfused")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    depth, nrm, (_, tcam) = _hbao_scene(32, 48)
    texs, _, tgb = _inputs(32, 48, 1)
    run = lambda: (tao.hbao(torch.from_numpy(depth), torch.from_numpy(nrm), tcam, 1,
                            tao.AOConfig(spp=2)),
                   poisson_denoise.poisson_denoise_pass([torch.from_numpy(texs[0])],
                                                        tgb, 1, tcfg))
    tcfg = _cfgs()[1]
    fused = run()
    assert calls == ["hbao_fused", "poisson_pass_fused"]
    with analytic.unfused():
        assert not tao.USE_FUSED_KERNEL and not poisson_kernel.USE_FUSED_PASS
        unfused = run()
    assert calls[2:] == ["hbao_unfused", "poisson_pass_unfused"]
    assert tao.USE_FUSED_KERNEL and poisson_kernel.USE_FUSED_PASS
    np.testing.assert_allclose(unfused[0][1].numpy(), fused[0][1].numpy(), atol=2e-4)
    np.testing.assert_allclose(unfused[1][0].numpy(), fused[1][0].numpy(), atol=5e-4,
                               rtol=5e-4)
