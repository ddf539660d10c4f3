"""The port's SSGI pieces vs the JAX package, on the CPU.

- The step table equals the JAX package's bit for bit.
- ``ssgi_sweep.sweep_ray_march`` (the march through the sweep kernel's
  plain version) against the JAX package's, on the same rays over the
  analytic scene at 48 x 64, frames 0-3, with and without the miss
  radiance. The JAX side runs eagerly, through its jnp executor, as its
  own tests run it. A decision that a float32 ulp can move (the atan2 of
  a bin, a hit test) may flip a pixel; at most 0.1% of pixels may flip
  (measured: none in 16 ray sets of 3072). Elsewhere uv and hit position
  agree to 1e-5 (measured 1.8e-7 and 9.5e-7) and the radiance exactly.
- ``ops.ssgi.ssgi`` against the JAX package's under ``jax.jit`` (as the
  composer runs it), the environment carried across by
  ``convert.env_from_numpy``: 1e-4 except at most 0.1% of pixels
  (measured: 1.2e-5 elsewhere; at frame 5 one pixel of 3072, 0.03%, where
  XLA's contracted multiply-add flips a hit).
- ``build_equirect_env(procedural_sky(64, 128))`` against the JAX
  package's, array by array, exactly, by the C++ route and by numpy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realism_effects_tpu as jre
from realism_effects_tpu import native as jnative
from realism_effects_tpu.core import brdf as jbrdf
from realism_effects_tpu.core import envmap as jenv
from realism_effects_tpu.core import math3d as jm
from realism_effects_tpu.core import rng as jrng
from realism_effects_tpu.core import sampling as jsamp
from realism_effects_tpu.core.framebuffers import GBuffer as JG
from realism_effects_tpu.core.framebuffers import VelocityBuffer as JV
from realism_effects_tpu.ops import ssgi as jssgi
from realism_effects_tpu.ops import ssgi_sweep as jsweep
import realism_effects_tpu_torch as tre
from realism_effects_tpu_torch import analytic, convert, native
from realism_effects_tpu_torch.core import brdf, envmap, math3d, rng, sampling
from realism_effects_tpu_torch.ops import ssgi as tssgi
from realism_effects_tpu_torch.ops import ssgi_sweep
from realism_effects_tpu_torch.ops.cuda_build import launches

H, W = 48, 64
FLIP_FRAC = 1e-3
_GB = ("diffuse", "normal", "roughness", "metalness", "emissive", "depth")
_VEL = ("velocity", "normal", "depth")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU runs here are a few thousand small ops a frame; with
    the test workers sharing the cores, torch's thread pool waits on
    descheduled threads at every op, so run them on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frame(first):
    """Analytic buffers (plane, box, sphere) of orbit frame ``first`` and
    both packages' camera matrices."""
    tcam = tre.PerspectiveCamera(50, W / H, 0.1, 100)
    gb, vel, color = analytic.frames_at(tcam, [first], H, W, "cpu",
                                        sphere=True)[0]
    jcam = jre.PerspectiveCamera(50, W / H, 0.1, 100)
    analytic.orbit(jcam, first)
    return gb, vel, color, tcam.matrices(), jcam.matrices()


@pytest.fixture(scope="module")
def jax_env():
    return jre.build_equirect_env(jre.procedural_sky(64, 128))


def _jax_table(frame, h, w, dirs=16, steps=32, min_radius=1.5):
    """`realism_effects_tpu/ops/ssgi_sweep.py:156-181`, run as
    ``sweep_ray_march`` runs it (eagerly)."""
    xi = jnp.mod(jnp.asarray(frame, jnp.float32) * 0.6180339887498949, 1.0)
    bin_width = 2.0 * jnp.pi / dirs
    diag = float((h * h + w * w) ** 0.5)
    ks = jnp.arange(steps, dtype=jnp.float32)
    radii = min_radius * (diag / min_radius) ** (ks / (steps - 1))
    ang = (jnp.arange(dirs, dtype=jnp.float32) + xi) * bin_width
    dxs = jnp.round(radii[None, :] * jnp.cos(ang)[:, None])
    dys = jnp.round(radii[None, :] * jnp.sin(ang)[:, None])
    s_eff = dxs * jnp.cos(ang)[:, None] + dys * jnp.sin(ang)[:, None]
    table = jnp.stack([dys.reshape(-1), dxs.reshape(-1), s_eff.reshape(-1)], -1)
    return np.asarray(table), np.asarray(
        jnp.concatenate([jnp.zeros((1,)), radii[:-1]]))


@pytest.mark.parametrize("frame,h,w", [(0, 48, 64), (3, 48, 64), (5, 1080, 1920),
                                       (4095, 270, 480)])
def test_step_table_equals_jax(frame, h, w):
    table, radii_prev, _ = ssgi_sweep.step_table(frame, h, w, 16, 32, 1.5)
    want_table, want_prev = _jax_table(frame, h, w)
    np.testing.assert_array_equal(table, want_table)
    np.testing.assert_array_equal(radii_prev, want_prev)


@pytest.mark.parametrize("miss_radiance", [False, True])
@pytest.mark.parametrize("frame", [0, 1, 2, 3])
def test_sweep_matches_jax(frame, miss_radiance):
    gb, _, _, tcam, jcam = _frame(3)
    view_pos = math3d.get_view_position(
        math3d.uv_grid(H, W), math3d.depth_to_view_z(gb.depth, tcam),
        tcam.projection_matrix, tcam.projection_matrix_inverse)
    rng_ = np.random.default_rng(frame)
    rays = []
    for _ in range(2):
        r = rng_.normal(size=(H, W, 3))
        r[..., 2] = -np.abs(r[..., 2]) * 0.3 - 0.05
        rays.append((r / np.linalg.norm(r, axis=-1, keepdims=True)).astype(np.float32))
    rad = rng_.uniform(0, 2, (H, W, 4)).astype(np.float16).astype(np.float32)
    noise = rng_.random((H, W)).astype(np.float32)
    vp = view_pos.numpy()
    want = jsweep.sweep_ray_march(
        jnp.asarray(vp), [jnp.asarray(r) for r in rays],
        jnp.asarray(gb.depth.numpy()), jcam, frame, 10.0, 10.0,
        bin_noise=jnp.asarray(noise), radiance=jnp.asarray(rad),
        miss_radiance=miss_radiance)
    launches.clear()
    got = ssgi_sweep.sweep_ray_march(
        view_pos, [torch.from_numpy(r) for r in rays], gb.depth, tcam, frame,
        10.0, 10.0, bin_noise=torch.from_numpy(noise),
        radiance=torch.from_numpy(rad), miss_radiance=miss_radiance)
    assert not launches
    hits = 0
    for (juv, jpos, jmiss, jgi), (uv, pos, miss, gi) in zip(want, got):
        jmiss = np.asarray(jmiss)
        same = jmiss == miss.numpy()
        assert (~same).mean() <= FLIP_FRAC
        hits += int((~jmiss).sum())
        np.testing.assert_allclose(uv.numpy()[same], np.asarray(juv)[same],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(pos.numpy()[same], np.asarray(jpos)[same],
                                   rtol=1e-6, atol=1e-5)
        np.testing.assert_array_equal(gi.numpy()[same], np.asarray(jgi)[same])
    assert hits > H * W  # both rays hit on most pixels


@pytest.fixture(scope="module")
def jax_ssgi():
    cfg = jssgi.SSGIConfig()
    return jax.jit(lambda gb, vel, acc, col, env, cam, frame: jssgi.ssgi(
        gb, vel, acc, col, env, cam, frame, cfg))


@pytest.mark.parametrize("frame", [2, 5])
def test_ssgi_matches_jax(jax_ssgi, jax_env, frame):
    gb, vel, color, tcam, jcam = _frame(frame)
    acc = np.random.default_rng(frame).uniform(0, 1.5, (H, W, 3)).astype(np.float32)
    want = jax_ssgi(JG(**{f: jnp.asarray(getattr(gb, f).numpy()) for f in _GB}),
                    JV(**{f: jnp.asarray(getattr(vel, f).numpy()) for f in _VEL}),
                    jnp.asarray(acc), jnp.asarray(color.numpy()), jax_env, jcam,
                    frame)
    got = tssgi.ssgi(gb, vel, torch.from_numpy(acc), color,
                     convert.env_from_numpy(jax_env, "cpu"), tcam, frame,
                     tssgi.SSGIConfig())
    for g, w_ in zip(got, want):
        assert g.shape == (H, W, 4) and bool(torch.isfinite(g).all())
        err = np.abs(g.numpy() - np.asarray(w_)).max(-1)
        assert (err > 1e-4).mean() <= FLIP_FRAC
    # every path runs: diffuse samples (-1 marks the rest), env samples
    assert (got[0][..., 0] == -1.0).any() and (got[0][..., 0] > 0).any()


def test_ssgi_march_trace_waits(monkeypatch):
    """``trace="march"`` runs (it waited for a later slice until the
    per-pixel march was ported; ``tests/test_torch_march.py`` holds it
    against the JAX package); an unknown trace raises."""
    gb, vel, color, tcam, _ = _frame(0)
    calls = []
    march = tssgi.view_space_ray_march
    monkeypatch.setattr(tssgi, "view_space_ray_march",
                        lambda *a: calls.append(1) or march(*a))
    out = tssgi.ssgi(gb, vel, torch.zeros(H, W, 3), color, None, tcam, 0,
                     tssgi.SSGIConfig(trace="march"))
    assert len(calls) == 2
    for g in out:
        assert g.shape == (H, W, 4) and bool(torch.isfinite(g).all())
    with pytest.raises(ValueError, match="trace"):
        tssgi.ssgi(gb, vel, torch.zeros(H, W, 3), color, None, tcam, 0,
                   tssgi.SSGIConfig(trace="binned"))


def _env_arrays(env):
    arrs = {f"mip{i}": m for i, m in enumerate(env.mips)}
    arrs.update(atlas=env.atlas.data, marginal=env.marginal,
                conditional=env.conditional, total_sum=env.total_sum,
                cdf_packed=env.cdf_packed)
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in arrs.items()}


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_env_build_matches_jax(route, monkeypatch):
    sky = jenv.procedural_sky(64, 128)
    np.testing.assert_array_equal(envmap.procedural_sky(64, 128), sky)
    if route == "numpy":
        monkeypatch.setattr(jnative, "build_equirect_cdf", lambda rgb: None)
        monkeypatch.setattr(native, "build_equirect_cdf", lambda rgb: None)
    elif not native.available():
        pytest.skip("no g++ to build native/envcdf.cpp")
    want = jenv.build_equirect_env(sky)
    got = envmap.build_equirect_env(sky, device="cpu")
    assert got.atlas.shapes == want.atlas.shapes
    assert got.max_mip_level == want.max_mip_level
    w_arrs, g_arrs = _env_arrays(want), _env_arrays(got)
    for k, v in w_arrs.items():
        assert g_arrs[k].dtype == v.dtype, k
        np.testing.assert_array_equal(g_arrs[k], v, err_msg=k)


@pytest.mark.parametrize("lod,quantize", [(0.0, False), (2.7, False),
                                          (1.6, True), ("map", True)])
def test_env_sampling_matches_jax(jax_env, lod, quantize):
    env = convert.env_from_numpy(jax_env, "cpu")
    r = np.random.default_rng(7)
    d = r.normal(size=(24, 40, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    lod_v = r.uniform(0, 6, (24, 40)).astype(np.float32) if lod == "map" else lod
    want = jenv.sample_equirect_color(jax_env, jnp.asarray(d), jnp.asarray(lod_v)
                                      if lod == "map" else lod, quantize=quantize)
    got = envmap.sample_equirect_color(env, torch.from_numpy(d), torch.from_numpy(lod_v)
                                       if lod == "map" else lod, quantize=quantize)
    # an ulp of atan2/acos in the uv times the sun's texel gradient
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=2e-4)
    noise = jnp.asarray(r.random((16, 16, 2)).astype(np.float32))
    for fast in (False, True):
        (jp, jd), (tp, td) = (jenv.sample_equirect_probability(jax_env, noise, fast=fast),
                              envmap.sample_equirect_probability(
                                  env, torch.from_numpy(np.array(noise)), fast=fast))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-5)


def test_mip_chain_and_blue_noise_transform_match_jax():
    tex = np.random.default_rng(3).random((20, 34, 3)).astype(np.float32)
    for a, b in zip(jsamp.build_mip_chain(jnp.asarray(tex)),
                    sampling.build_mip_chain(torch.from_numpy(tex))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=0)
    fn_j = lambda t: jnp.sin(t[..., :2] * 3.0)
    fn_t = lambda t: torch.sin(t[..., :2] * 3.0)
    want = jrng.blue_noise_transform(70, 150, 9, fn_j)
    got = rng.blue_noise_transform(70, 150, 9, fn_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def _unit(r, shape):
    v = r.normal(size=shape + (3,)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.mark.parametrize("name", ["f_schlick", "ggx_vndf_pdf",
                                  "eval_disney_diffuse", "eval_disney_specular",
                                  "sample_ggx_vndf", "onb", "calculate_angles",
                                  "mis_heuristic"])
def test_brdf_matches_jax(name):
    r = np.random.default_rng(5)
    s = (11, 13)
    u = lambda lo=0.01, hi=0.99: r.uniform(lo, hi, s).astype(np.float32)
    n, l, v = _unit(r, s), _unit(r, s), _unit(r, s)
    n[0, 0] = (0.0, 0.0, 1.0)  # the onb's other up vector
    args = {
        "f_schlick": (r.uniform(0, 1, s + (3,)).astype(np.float32), u()),
        "ggx_vndf_pdf": (u(), u(), u()),
        "eval_disney_diffuse": (u(), u(), u(), u(), u(0, 1)),
        "eval_disney_specular": (u(), u(), u(), u()),
        "sample_ggx_vndf": (v, u(), u(), u(), u()),
        "onb": (n,),
        "calculate_angles": (l, v, n),
        "mis_heuristic": (u(), u()),
    }[name]
    want = getattr(jbrdf, name)(*[jnp.asarray(a) for a in args])
    got = getattr(brdf, name)(*[torch.from_numpy(a) for a in args])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    atol = 2e-6
    if name == "sample_ggx_vndf":
        atol = atol + _vndf_rim_bound(*args)[..., None]
    for g, w_ in zip(got, want):
        err = np.abs(g.numpy() - np.asarray(w_))
        excess = err - (atol + 2e-5 * np.abs(np.asarray(w_)))
        assert excess.max() <= 0.0, (err.max(), np.unravel_index(
            excess.argmax(), excess.shape))


def _vndf_rim_bound(v, ax, ay, r1, r2):
    """Per-sample error bound of ``sample_ggx_vndf`` from the conditioning
    of its rim term sqrt(c), c = 1 - p1^2 - p2^2, in float64.

    p1 and p2 come from cos/sin, whose float32 results differ by an ulp
    between XLA:CPU and ATen (vectorised differently on each host), so c
    moves by up to dc = 2 (|p1| + |p2|) 2^-23 and sqrt(c) by
    sqrt(c + dc) - sqrt(max(c - dc, 0)), which is large near the rim
    (c -> 0). That moves the unnormalised half vector N along vh, and the
    normalised result by at most |(ax vh_x, ay vh_y, vh_z)| / |N| times
    it. Measured: 7.98e-5 at the sample with c = 2.0e-5, whose bound is
    7.9e-4; the median bound of the 143 samples is 5e-7, and 72% of them
    are held under 1e-6 of it."""
    v = v.astype(np.float64)
    ax, ay, r1, r2 = (a.astype(np.float64) for a in (ax, ay, r1, r2))
    vh = np.stack([ax * v[..., 0], ay * v[..., 1], v[..., 2]], -1)
    vh /= np.linalg.norm(vh, axis=-1, keepdims=True)
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv_len = 1.0 / np.sqrt(np.maximum(lensq, 1e-20))
    t1 = np.stack([-vh[..., 1] * inv_len, vh[..., 0] * inv_len,
                   np.zeros_like(lensq)], -1)
    t2 = np.cross(vh, t1)
    p1 = np.sqrt(r1) * np.cos(2.0 * np.pi * r2)
    p2 = np.sqrt(r1) * np.sin(2.0 * np.pi * r2)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * np.sqrt(np.maximum(1.0 - p1 * p1, 0.0)) + s * p2
    c = 1.0 - p1 * p1 - p2 * p2
    dc = 2.0 * (np.abs(p1) + np.abs(p2)) * 2.0 ** -23
    d_root = np.sqrt(np.maximum(c + dc, 0.0)) - np.sqrt(np.maximum(c - dc, 0.0))
    nh = (p1[..., None] * t1 + p2[..., None] * t2
          + np.sqrt(np.maximum(c, 0.0))[..., None] * vh)
    scaled = lambda a: np.stack([ax * a[..., 0], ay * a[..., 1], a[..., 2]], -1)
    n_len = np.linalg.norm(scaled(nh), axis=-1)
    return (d_root * np.linalg.norm(scaled(vh), axis=-1)
            / np.maximum(n_len, 1e-12)).astype(np.float32)


def test_view_helpers_match_jax():
    _, _, _, tcam, jcam = _frame(1)
    r = np.random.default_rng(8)
    p = r.normal(size=(9, 10, 3)).astype(np.float32) - np.float32([0, 0, 4])
    d = _unit(r, (9, 10))
    pairs = [
        (jm.view_to_screen(jnp.asarray(p), jcam.projection_matrix),
         math3d.view_to_screen(torch.from_numpy(p), tcam.projection_matrix)),
        (jm.transform_dir(jcam.view_matrix, jnp.asarray(d)),
         math3d.transform_dir(tcam.view_matrix, torch.from_numpy(d))),
        (jm.transform_dir_transpose(jcam.view_matrix, jnp.asarray(d)),
         math3d.transform_dir_transpose(tcam.view_matrix, torch.from_numpy(d))),
        (jm.reflect(jnp.asarray(d), jnp.asarray(d[::-1])),
         math3d.reflect(torch.from_numpy(d), torch.from_numpy(d[::-1].copy()))),
        (jm.luminance(jnp.asarray(p)), math3d.luminance(torch.from_numpy(p))),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
