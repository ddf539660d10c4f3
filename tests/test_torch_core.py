"""Port core substrate vs the JAX package, on the CPU.

Tolerances: the packing codecs and the blue noise are bit manipulation
and table lookups, so they must agree bit for bit (the Poisson kernel
decodes the packed bits on the device). The octahedral decode ends in a
normalisation whose square root XLA:CPU does not round correctly when it
fuses it (about one result in ten is one ulp off the correctly rounded
value, against JAX's own unfused ``jnp.sqrt``), so the decoded normals
agree to 2.5e-7. The transforms are float32 arithmetic in the same
order; 1e-6 absorbs such one-ulp differences.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from realism_effects_tpu.core import camera as jcam
from realism_effects_tpu.core import math3d as jm
from realism_effects_tpu.core import packing as jp
from realism_effects_tpu.core import rng as jr
from realism_effects_tpu_torch.core import camera as tcam
from realism_effects_tpu_torch.core import math3d as tm
from realism_effects_tpu_torch.core import packing as tp
from realism_effects_tpu_torch.core import rng as tr


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _normals(n, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v[:5] = 0.0                                  # background: no normal
    v[5:8] = [[0, 0, 1], [0, 0, -1], [1, 0, 0]]  # octahedron corners
    return v.astype(np.float32)


def test_oct_and_normal_packing_bit_exact():
    n = _normals(4000)
    valid = np.abs(n).sum(-1) > 0
    got = tp.pack_normal(torch.from_numpy(n)).numpy()
    want = np.asarray(jp.pack_normal(jnp.asarray(n)))
    np.testing.assert_array_equal(_bits(got)[valid], _bits(want)[valid])
    packed = np.where(valid, want, 0.0).astype(np.float32)
    np.testing.assert_array_equal(
        tp.unpack_half2x16(torch.from_numpy(packed)).numpy(),
        np.asarray(jp.unpack_half2x16(jnp.asarray(packed))))
    np.testing.assert_allclose(
        tp.unpack_normal(torch.from_numpy(packed)).numpy(),
        np.asarray(jp.unpack_normal(jnp.asarray(packed))),
        rtol=0, atol=2.5e-7)
    f = np.random.default_rng(1).random((500, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tp.decode_oct(torch.from_numpy(f)).numpy(),
        np.asarray(jp.decode_oct(jnp.asarray(f))), rtol=0, atol=2.5e-7)


def test_half2x16_bit_exact_with_subnormals():
    rng = np.random.default_rng(2)
    v = np.concatenate([
        rng.normal(size=(300, 2)) * 100.0,
        rng.normal(size=(100, 2)) * 1e-6,          # f16 subnormals
        np.array([[0.0, -0.0], [6.1e-5, -6.0e-8], [65504.0, -65504.0],
                  [1e-9, 7e5]]),                   # edges, underflow, inf
    ]).astype(np.float32)
    got = tp.pack_half2x16(torch.from_numpy(v)).numpy()
    want = np.asarray(jp.pack_half2x16(jnp.asarray(v)))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(
        tp.unpack_half2x16(torch.from_numpy(np.array(want))).numpy(),
        np.asarray(jp.unpack_half2x16(jnp.asarray(want))))


@pytest.mark.parametrize("index,row_offset", [(0, 0), (7, 0), (4095, 3),
                                              (123456, -5)])
def test_blue_noise_bit_exact(index, row_offset):
    got = tr.rolled_noise_tile(index, row_offset=row_offset).numpy()
    want = np.asarray(jr.rolled_noise_tile(index, row_offset=row_offset))
    np.testing.assert_array_equal(got, want)
    got = tr.blue_noise_image(70, 200, index, row_offset=row_offset).numpy()
    want = np.asarray(jr.blue_noise_image(70, 200, index,
                                          row_offset=row_offset))
    np.testing.assert_array_equal(got, want)


def test_pcg4d_matches():
    v = np.random.default_rng(3).integers(0, 2**32, (64, 4), dtype=np.uint64)
    v = v.astype(np.uint32)
    np.testing.assert_array_equal(tr.pcg4d(v), np.asarray(jr.pcg4d(jnp.asarray(v))))


def _cameras():
    jc = jcam.PerspectiveCamera(50, 1.6, 0.1, 100)
    tc = tcam.PerspectiveCamera(50, 1.6, 0.1, 100)
    for c in (jc, tc):
        c.set_position(3, 2.5, 4)
        c.look_at((0, 0.5, 0))
        c.jitter(200, 70, 5)
    return jc, tc


def test_camera_matrices_equal():
    jc, tc = _cameras()
    jm_, tm_ = jc.matrices(), tc.matrices()
    for f in ("projection_matrix", "projection_matrix_inverse",
              "view_matrix", "camera_matrix_world", "position"):
        np.testing.assert_array_equal(getattr(tm_, f),
                                      np.asarray(getattr(jm_, f)))
    assert tm_.near == float(jm_.near) and tm_.far == float(jm_.far)
    np.testing.assert_allclose(tm_.projection_view_matrix,
                               np.asarray(jm_.projection_view_matrix),
                               rtol=1e-6, atol=1e-6)


def test_transforms_match():
    h, w = 70, 200
    rng = np.random.default_rng(4)
    depth = rng.uniform(0.5, 1.0, (h, w)).astype(np.float32)
    jc, tc = _cameras()
    jmat, tmat = jc.matrices(), tc.matrices()
    uv_t = tm.uv_grid(h, w)
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(jm.uv_grid(h, w)),
                               rtol=0, atol=1e-6)
    got = tm.screen_to_world(uv_t, torch.from_numpy(depth),
                             tmat.camera_matrix_world,
                             tmat.projection_matrix_inverse).numpy()
    want = np.asarray(jm.screen_to_world(
        jm.uv_grid(h, w), jnp.asarray(depth), jmat.camera_matrix_world,
        jmat.projection_matrix_inverse))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tm.depth_to_view_z(torch.from_numpy(depth), tmat).numpy(),
        np.asarray(jm.depth_to_view_z(jnp.asarray(depth), jmat)),
        rtol=1e-6, atol=1e-6)
    v = rng.normal(size=(h, w, 3)).astype(np.float32)
    np.testing.assert_allclose(tm.fwidth(torch.from_numpy(v)).numpy(),
                               np.asarray(jm.fwidth(jnp.asarray(v))),
                               rtol=0, atol=1e-6)


def test_sampling_matches():
    from realism_effects_tpu.core import sampling as js
    from realism_effects_tpu_torch.core import sampling as ts

    rng = np.random.default_rng(5)
    tex = rng.normal(size=(40, 60, 3)).astype(np.float32)
    uv = rng.uniform(-0.1, 1.1, (30, 50, 2)).astype(np.float32)
    t, u = torch.from_numpy(tex), torch.from_numpy(uv)
    np.testing.assert_array_equal(
        ts.sample_nearest(t, u).numpy(),
        np.asarray(js.sample_nearest(jnp.asarray(tex), jnp.asarray(uv))))
    for half in (False, True):
        np.testing.assert_allclose(
            ts.sample_bilinear(t, u, half=half).numpy(),
            np.asarray(js.sample_bilinear(jnp.asarray(tex), jnp.asarray(uv),
                                          half=half)), rtol=0, atol=1e-6)


def test_cosine_hemisphere_and_r2_match():
    from realism_effects_tpu.core import brdf as jb
    from realism_effects_tpu_torch.core import brdf as tb

    rng = np.random.default_rng(6)
    n = _normals(2000)[8:]
    u = rng.random((len(n), 2)).astype(np.float32)
    np.testing.assert_allclose(
        tb.cosine_sample_hemisphere(torch.from_numpy(n), torch.from_numpy(u)).numpy(),
        np.asarray(jb.cosine_sample_hemisphere(jnp.asarray(n), jnp.asarray(u))),
        rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tr.r2_sequence(50), jr.r2_sequence(50))
    assert tr.r2_sequence_point(17) == jr.r2_sequence_point(17)


def test_ao_compose_matches():
    from realism_effects_tpu.ops.compose import ao_compose as j_compose
    from realism_effects_tpu_torch.ops.compose import ao_compose as t_compose

    rng = np.random.default_rng(7)
    color = rng.random((20, 30, 3)).astype(np.float32)
    ao = rng.random((20, 30)).astype(np.float32)
    depth = rng.uniform(0.99, 1.0, (20, 30)).astype(np.float32)
    args = dict(power=2.0, ao_color=(0.1, 0.2, 0.05))
    np.testing.assert_array_equal(
        t_compose(*map(torch.from_numpy, (color, ao, depth)), **args).numpy(),
        np.asarray(j_compose(*map(jnp.asarray, (color, ao, depth)), **args)))


# --- the reference's codecs and the remaining helpers -----------------------

@pytest.mark.parametrize("codec", ["color", "rgbe8", "vec4"])
def test_codecs_match(codec):
    """The colour codecs of `gbuffer_packing.glsl` on the JAX tests'
    inputs (``tests/test_core.py``): the encoding bit for bit where it is
    integer arithmetic (colour, vec4), to 1e-6 relative where it takes a
    log2 and an exp2 (RGBE8, whose exponent a log2 ulp could move at an
    exact power of 2: none here), and each round trip within the JAX
    tests' bounds (1/255; RGBE8 2% relative)."""
    seed, lo, hi, ch = {"color": (6, 0, 1, 3), "rgbe8": (7, 0, 50, 3),
                        "vec4": (8, 0, 1, 4)}[codec]
    x = np.random.default_rng(seed).uniform(lo, hi, size=(64, ch)).astype(np.float32)
    enc, dec = {"color": ("color2float", "float2color"),
                "rgbe8": ("encode_rgbe8", "decode_rgbe8"),
                "vec4": ("vec4_to_float", "float_to_vec4")}[codec]
    got = getattr(tp, enc)(torch.from_numpy(x))
    want = getattr(jp, enc)(jnp.asarray(x))
    back = getattr(tp, dec)(got).numpy()
    jback = np.asarray(getattr(jp, dec)(want))
    if codec == "rgbe8":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
        np.testing.assert_allclose(back, jback, rtol=1e-6, atol=0)
        assert (np.abs(back - x) / (x + 1e-3)).max() < 0.02
    else:
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
        np.testing.assert_array_equal(back, jback)
        assert np.abs(back - x).max() < 1.0 / 255.0


def test_view_z_depth_and_world_to_screen_match():
    """``view_z_to_perspective_depth`` round-trips ``perspective_depth_to_
    view_z`` to the JAX test's 1e-5 and equals the JAX function to 1e-6;
    ``world_to_screen`` of the jittered camera to 1e-6 (float32 in the
    same order)."""
    near, far = 0.1, 100.0
    depth = np.linspace(0.01, 0.999, 32, dtype=np.float32)
    vz = tm.perspective_depth_to_view_z(torch.from_numpy(depth), near, far)
    back = tm.view_z_to_perspective_depth(vz, near, far).numpy()
    np.testing.assert_allclose(back, depth, atol=1e-5)
    jvz = jnp.asarray(vz.numpy())
    np.testing.assert_allclose(
        back, np.asarray(jm.view_z_to_perspective_depth(jvz, near, far)),
        rtol=0, atol=1e-6)
    jc, tc = _cameras()
    jmat, tmat = jc.matrices(), tc.matrices()
    p = np.random.default_rng(9).uniform(-2, 2, (40, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tm.world_to_screen(torch.from_numpy(p), tmat.view_matrix,
                           tmat.projection_matrix).numpy(),
        np.asarray(jm.world_to_screen(jnp.asarray(p), jmat.view_matrix,
                                      jmat.projection_matrix)),
        rtol=1e-6, atol=1e-6)


def test_r3_and_blue_noise_generation_match():
    """The R3 sequence and the blue-noise generator equal the JAX
    package's, and the generator's default tile is the committed asset."""
    for n in (0, 1, 17, 1000):
        assert tr.r3_sequence_point(n) == jr.r3_sequence_point(n)
    np.testing.assert_array_equal(tr.generate_blue_noise(32, 2, seed=3),
                                  jr.generate_blue_noise(32, 2, seed=3))
    np.testing.assert_array_equal(
        tr._generate_blue_noise_channel(np.random.default_rng(1), 16),
        jr._generate_blue_noise_channel(np.random.default_rng(1), 16))
    np.testing.assert_array_equal(tr.generate_blue_noise(), tr.blue_noise_tile())


def test_did_camera_move_matches():
    jc, tc = _cameras()
    assert tcam.did_camera_move(None, tc.matrices()) is True
    before_t, before_j = tc.matrices(), jc.matrices()
    assert tcam.did_camera_move(before_t, tc.matrices()) is False
    for c in (jc, tc):
        c.set_position(3, 2.5, 4.01)
    for prev_t, prev_j, eps in ((before_t, before_j, 1e-6), (before_t, before_j, 1.0)):
        assert tcam.did_camera_move(prev_t, tc.matrices(), eps) == \
            jcam.did_camera_move(prev_j, jc.matrices(), eps)
    assert tcam.did_camera_move(before_t, tc.matrices()) is True
