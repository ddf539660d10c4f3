"""Port companion post-FX (tone mapping, vignette, bloom, 3D LUT) vs the
JAX package, on the CPU.

Each ``apply`` runs on the same inputs on both sides; the uniforms are
float32 on both (the port rounds its host floats). Measured: tone mapping
and the LUT bit-identical (bound 1e-6); vignette 1.8e-6 on values up to
6, 2.2e-6 relative (bound rtol 1e-5: XLA's norm and smoothstep round a
vignette factor of about 0.5 one ulp apart, and the HDR colour scales
it); bloom 9.5e-7 on values up to 8.3 (bound 1e-5: the 8-level
pyramid's means and lerps round in XLA's order).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from realism_effects_tpu.effects import postfx as jp
from realism_effects_tpu_torch.effects import postfx as tp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Ctx:
    def __init__(self, params):
        self.params = params


def _apply(name, color, *args, **uniforms):
    jeff, teff = getattr(jp, name)(*args), getattr(tp, name)(*args)
    u = {**teff.uniforms(), **uniforms}
    want, _ = jeff.apply(_Ctx({jeff.name: {k: jnp.float32(v) for k, v in u.items()}}),
                         jnp.asarray(color), {})
    got, _ = teff.apply(_Ctx({teff.name: u}), torch.from_numpy(color), {})
    return got.numpy(), np.asarray(want)


def _hdr(h, w, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, 1.0, (h, w, 3)) ** 3 * 6.0).astype(np.float32)


@pytest.mark.parametrize("exposure", [1.0, 0.7])
def test_aces_filmic_matches_jax(exposure):
    x = _hdr(48, 64, 1)
    got = tp.aces_filmic(torch.from_numpy(x), exposure).numpy()
    np.testing.assert_allclose(got, np.asarray(jp.aces_filmic(jnp.asarray(x), exposure)),
                               rtol=0, atol=1e-6)
    g, w = _apply("ToneMappingEffect", x, exposure=exposure)
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_vignette_matches_jax():
    g, w = _apply("VignetteEffect", _hdr(45, 80, 2), offset=0.3, darkness=0.8)
    np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)
    assert g[0, 0].sum() < 0.5 * _hdr(45, 80, 2)[0, 0].sum()   # corners darken


@pytest.mark.parametrize("h,w", [(54, 96), (37, 61)])
def test_bloom_matches_jax(h, w):
    x = _hdr(h, w, 3)
    g, want = _apply("BloomEffect", x)
    np.testing.assert_allclose(g, want, rtol=0, atol=1e-5)
    assert (g >= x - 1e-6).all() and (g - x).max() > 0.01   # additive glow


def _grading_lut(s):
    r, g, b = np.meshgrid(*[np.arange(s) / (s - 1)] * 3, indexing="ij")
    return np.stack([r ** 1.2, np.sqrt(g), 0.1 + 0.8 * b + 0.05 * r], -1).astype(np.float32)


def test_lut_matches_jax():
    x = np.random.default_rng(4).uniform(-0.1, 1.1, (33, 47, 3)).astype(np.float32)
    g, w = _apply("LUT3DEffect", x, _grading_lut(17))
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_identity_lut_is_identity():
    s = 8
    r, g, b = np.meshgrid(*[np.arange(s) / (s - 1)] * 3, indexing="ij")
    lut = np.stack([r, g, b], -1).astype(np.float32)
    img = np.random.default_rng(2).uniform(size=(16, 16, 3)).astype(np.float32)
    out, _ = tp.LUT3DEffect(lut).apply(_Ctx({}), torch.from_numpy(img), {})
    np.testing.assert_allclose(out.numpy(), img, atol=1e-5)


def test_load_lut_3dl(tmp_path):
    """A 4^3 .3dl file (blue fastest, 12-bit values) parses as the JAX
    loader parses it."""
    s = 4
    cube = _grading_lut(s)
    lines = ["# a test cube", " ".join(str(int(v)) for v in np.linspace(0, 1023, s))]
    for r in range(s):
        for g in range(s):
            for b in range(s):
                lines.append(" ".join(str(int(round(v * 4095))) for v in cube[r, g, b]))
    path = tmp_path / "t.3dl"
    path.write_text("\n".join(lines) + "\n")
    got = tp.load_lut_3dl(str(path))
    assert got.shape == (s, s, s, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jp.load_lut_3dl(str(path)))
    np.testing.assert_allclose(got, cube, atol=0.5 / 4095 + 1e-7)
    path.write_text("\n".join(lines[:-1]) + "\n")
    with pytest.raises(ValueError, match="expected 64"):
        tp.load_lut_3dl(str(path))
