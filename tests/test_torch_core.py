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
