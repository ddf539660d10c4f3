"""The port's FXAA and SMAA vs the JAX package, on the CPU.

``fxaa`` and ``smaa`` run on the patterns of the JAX package's own tests
(``tests/test_fxaa.py``, ``tests/test_smaa.py``: staircases, half-planes
of several slopes, a one-pixel step, 45-degree edges, low-contrast
noise, flat images), all at 64 x 64 so that the JAX side compiles its
operations once, and on seeded noise images, against the JAX
functions op by op: max 1e-6 (measured: equal on every pattern; 6e-8 on
the noise images, an ulp of a bilinear lerp). SMAA's edges and run
extents are exact integer decisions on the luma, computed in the JAX
package's order, so a flip would show as an error near 1.

Both effects also run in a composer through ``render_external`` on the
analytic scene's colour. There the port's frame equals the JAX function
op by op on the same colour (max 1e-6, measured 0). The JAX composer
runs FXAA jitted: XLA's fused arithmetic moves a search fetch by an ulp,
and now and then that flips an end-of-edge test and the pixel's blend
(measured: 3 pixels of 2240 off by more than 1e-4, the largest 1.1e-2).
So against the JAX composer: the SSGI slice's mean (1e-5) and share (1%
of pixels off by more than 1e-4), and a max of 2e-2 for such a flip.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realism_effects_tpu as jre
from realism_effects_tpu.core.framebuffers import GBuffer as JG
from realism_effects_tpu.core.framebuffers import VelocityBuffer as JV
from realism_effects_tpu.effects.fxaa import fxaa as jfxaa
from realism_effects_tpu.effects.smaa import smaa as jsmaa
import realism_effects_tpu_torch as tre
from realism_effects_tpu_torch import analytic
from realism_effects_tpu_torch.effects.fxaa import fxaa
from realism_effects_tpu_torch.effects.smaa import smaa

TOL = 1e-6
COMPOSER_MAX_TOL, COMPOSER_MEAN_TOL, PIX_TOL, PIX_FRAC = 2e-2, 1e-5, 1e-4, 1e-2
_GB = ("diffuse", "normal", "roughness", "metalness", "emissive", "depth")
_VEL = ("velocity", "normal", "depth")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _staircase(h=64, w=64):
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    img = (xx + 0.35 * h > yy * 2.0).astype(np.float32)
    return np.stack([img] * 3, -1)


def _halfplane(h, w, y0, slope):
    """(aliased binary image, analytic coverage) of the edge y = y0 + x slope."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64) + 0.5
    f = yy - (y0 + xx * slope)
    binary = np.repeat((f > 0).astype(np.float32)[..., None], 3, -1)
    cov = np.clip(f / np.sqrt(1 + slope * slope) + 0.5, 0, 1)
    return binary, np.repeat(cov.astype(np.float32)[..., None], 3, -1)


def _l_step():
    img = np.zeros((64, 64, 3), np.float32)
    img[32:, :] = 1.0
    img[31:, :8] = 1.0
    return img


def _noise(seed, h=64, w=64):
    r = np.random.default_rng(seed)
    base = r.uniform(0, 1, (h // 4 + 1, w // 4 + 1, 3)).repeat(4, 0).repeat(4, 1)[:h, :w]
    return (base + r.normal(0, 0.05, (h, w, 3))).astype(np.float32)


PATTERNS = {
    "staircase": _staircase,
    "staircase_low_contrast": lambda: _staircase() * 0.02,
    "flat": lambda: np.full((64, 64, 3), 0.4, np.float32),
    "shallow": lambda: _halfplane(64, 64, 20.0, 1 / 8)[0],
    "steep": lambda: np.transpose(_halfplane(64, 64, 20.0, 1 / 8)[0], (1, 0, 2)).copy(),
    "interior": lambda: _halfplane(64, 64, 32.0, 1 / 16)[0],
    "l_step": _l_step,
    "diagonal_midline": lambda: _halfplane(64, 64, 16.5, 1.0)[0],
    "diagonal_mirrored": lambda: _halfplane(64, 64, 48.5, -1.0)[0],
    "diagonal_offset": lambda: _halfplane(64, 64, 16.2, 1.0)[0],
    "noise_below_threshold": lambda: np.repeat(
        (0.5 + np.random.default_rng(3).uniform(-0.04, 0.04, (64, 64, 1))).astype(np.float32),
        3, -1),
    "noise_0": lambda: _noise(0),
    "noise_1": lambda: _noise(1),
}


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("name", ["fxaa", "smaa"])
def test_aa_matches_jax(name, pattern):
    img = PATTERNS[pattern]()
    port, ref = {"fxaa": (fxaa, jfxaa), "smaa": (smaa, jsmaa)}[name]
    got = port(torch.from_numpy(img)).numpy()
    want = np.asarray(ref(jnp.asarray(img)))
    assert got.shape == img.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_fxaa_properties():
    """The JAX package's FXAA properties hold on the port: flat and
    low-contrast images pass through, a staircase gains edge gradients
    and keeps its mean."""
    flat = PATTERNS["flat"]()
    np.testing.assert_allclose(fxaa(torch.from_numpy(flat)).numpy(), flat, atol=1e-6)
    low = PATTERNS["staircase_low_contrast"]()
    np.testing.assert_allclose(fxaa(torch.from_numpy(low)).numpy(), low, atol=1e-6)
    img = _staircase()
    out = fxaa(torch.from_numpy(img)).numpy()
    interior = out[4:-4, 4:-4, 0]
    assert ((interior > 0.05) & (interior < 0.95)).mean() > 0.012
    assert abs(out.mean() - img.mean()) < 0.02


def test_smaa_properties():
    """The JAX package's SMAA properties hold on the port: a slope-1/8
    edge moves 5x closer to its analytic coverage, a 45-degree midline
    edge nearly exactly, interiors stay."""
    for y0, slope, ratio in ((20.0, 1 / 8, 0.2), (16.5, 1.0, 0.05)):
        img, cov = _halfplane(64, 64, y0, slope)
        out = smaa(torch.from_numpy(img)).numpy()
        assert np.abs(out - cov).mean() < ratio * np.abs(img - cov).mean()
    img, _ = _halfplane(64, 64, 32.0, 1 / 16)
    out = smaa(torch.from_numpy(img)).numpy()
    assert np.abs(out[:16] - img[:16]).max() < 1e-6
    assert np.abs(out[-16:] - img[-16:]).max() < 1e-6


def test_aa_effects_in_composer_match_jax():
    h, w = 40, 56
    cam = tre.PerspectiveCamera(50, w / h, 0.1, 100)
    frames = analytic.frames_at(cam, range(2), h, w, "cpu", sphere=True)
    images = {}
    ops = {"fxaa": jfxaa, "smaa": jsmaa}
    for which in ("fxaa", "smaa"):
        jcam = jre.PerspectiveCamera(50, w / h, 0.1, 100)
        jcomp = jre.EffectComposer(jre.Scene(), jcam, w, h)
        jcomp.add_effect({"fxaa": jre.FXAAEffect, "smaa": jre.SMAAEffect}[which]())
        comp = tre.EffectComposer(None, cam, w, h, device="cpu")
        comp.add_effect({"fxaa": tre.FXAAEffect, "smaa": tre.SMAAEffect}[which]())
        got = analytic.run_frames(comp, cam, frames, range(2))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for i, ((gb, vel, color), g) in enumerate(zip(frames, got)):
                analytic.orbit(jcam, i)
                want = np.asarray(jcomp.render_external(
                    JG(**{f: jnp.asarray(getattr(gb, f).numpy()) for f in _GB}),
                    JV(**{f: jnp.asarray(getattr(vel, f).numpy()) for f in _VEL}),
                    jnp.asarray(color.numpy()), dt=1 / 60))
                g_ = g.numpy()
                op_by_op = np.asarray(ops[which](jnp.asarray(color.numpy())))
                np.testing.assert_allclose(g_, op_by_op, rtol=0, atol=TOL)
                err = np.abs(g_ - want)
                assert err.max() <= COMPOSER_MAX_TOL
                assert err.mean() <= COMPOSER_MEAN_TOL
                assert (err.max(-1) > PIX_TOL).mean() <= PIX_FRAC
                images[which, i] = g
    # each effect changed the frame somewhere (the analytic edges)
    assert not torch.equal(images["fxaa", 1], frames[1][2])
    assert not torch.equal(images["smaa", 1], frames[1][2])
