"""Port GTAO vs the JAX package, on the CPU.

``ops.ao.gtao`` is plain jnp in the JAX package (no Pallas kernel) and
plain torch in the port, on the same depth (a seeded surface with a
step, a slope and a background band) and camera.

Tolerance: HBAO's port tolerance (``tests/test_torch_hbao.py``), atol
2e-4 and rtol 1e-4, on all but at most 0.1% of the pixels, those within
1e-3, and a mean error of at most 1e-5. The depth-derived normals and the
sample directions differ from XLA's by float32 ulps (about 1e-7); where a
sample lands on a texel boundary, that ulp sends its nearest fetch to
the next texel, which changes that one sample's term (measured at spp
16: one pixel of 15360, 3.9e-4, on a sample at row 84.0 exactly; at spp
8 none, max 6.6e-6). ``GTAOEffect`` at half resolution (GTAO on the
nearest-halved G-buffer, then upsample, denoise and compose) is held to
HBAO's tolerance on every pixel against the JAX effect applied op by op
(measured 4.8e-7).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import realism_effects_tpu as jre
from realism_effects_tpu.composer import FrameContext as JContext
from realism_effects_tpu.core.camera import PerspectiveCamera as JCam
from realism_effects_tpu.core.framebuffers import GBuffer as JG
from realism_effects_tpu.core.rng import vogel_disk as j_vogel
from realism_effects_tpu.ops import ao as jao
import realism_effects_tpu_torch as tre
from realism_effects_tpu_torch import analytic
from realism_effects_tpu_torch.composer import FrameContext as TContext
from realism_effects_tpu_torch.core.camera import PerspectiveCamera as TCam
from realism_effects_tpu_torch.core.rng import vogel_disk
from realism_effects_tpu_torch.ops import ao as tao

H, W = 96, 160
FLIP_TOL = 1e-3    # a pixel one of whose samples a float32 ulp moves
_GB = ("diffuse", "normal", "roughness", "metalness", "emissive", "depth")


def _scene(h, w, seed=3):
    """Depth of a sloped floor with a raised step and a seeded ripple, a
    background band on top; and the two cameras."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    depth = 0.93 + 0.05 * (yy / h) - 0.02 * (xx > w // 2) \
        + 0.001 * np.sin(xx * 0.3 + rng.uniform(0, 6)) \
        + rng.uniform(-2e-4, 2e-4, (h, w))
    depth[-h // 8:] = 1.0
    cams = []
    for cls in (JCam, TCam):
        c = cls(50, w / h, 0.1, 80)
        c.set_position(0.3, 1.5, 5.0)
        c.look_at((0, 0.5, 0))
        cams.append(c.matrices())
    return depth.astype(np.float32), cams


def _check(got, want, shape, flip_frac):
    """HBAO's tolerance on all but ``flip_frac`` of the pixels, those
    within FLIP_TOL."""
    assert got.shape == shape and np.isfinite(got).all()
    err = np.abs(got - want)
    assert (err > 2e-4 + 1e-4 * np.abs(want)).mean() <= flip_frac
    assert err.max() <= FLIP_TOL and err.mean() <= 1e-5


def test_vogel_disk_matches_jax():
    for n in (1, 8, 16, 33):
        np.testing.assert_array_equal(vogel_disk(n), j_vogel(n))
    np.testing.assert_array_equal(tao.VOGEL16, jao.VOGEL16)


def test_depth_stencil_matches_jax():
    depth, (jcam, tcam) = _scene(24, 40)
    got = tao._pack_depth_stencil(torch.from_numpy(depth)).numpy()
    want = np.asarray(jao._pack_depth_stencil(jnp.asarray(depth)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("spp,frame,distance", [(16, 3, 2.0), (8, 0, 1.2)])
def test_gtao_matches_jax(spp, frame, distance):
    """spp 16 takes the reference's table, spp 8 ``vogel_disk(8)``."""
    depth, (jcam, tcam) = _scene(H, W)
    want = np.asarray(jao.gtao(jnp.asarray(depth), jcam, frame,
                               jao.AOConfig(spp=spp, distance=distance)))
    got = tao.gtao(torch.from_numpy(depth), tcam, frame,
                   tao.AOConfig(spp=spp, distance=distance)).numpy()
    _check(got, want, (H, W), 1e-3)
    assert (got[-H // 8:] == 1.0).all()      # background
    assert got[: -H // 8].min() < 0.95        # some occlusion


def test_gtao_effect_at_half_resolution_matches_jax():
    """``GTAOEffect(resolution_scale=0.5)``: GTAO on the nearest-halved
    G-buffer, the AO upsampled, denoised and composed at full size, as
    the JAX package's ``AOEffect.apply`` does for any AO kind; both
    effects applied op by op to the flagship's ray-cast buffers."""
    cam = tre.PerspectiveCamera(50, W / H, 0.1, 100)
    gb, _, color = analytic.frames_at(cam, [0], H, W, "cpu", sphere=True)[0]
    jcam = JCam(50, W / H, 0.1, 100)
    analytic.orbit(jcam, 0)
    jm, tm = jcam.matrices(), cam.matrices()
    params = {"gtao": {"power": 2.0}}
    jctx = JContext(
        gbuffer=JG(**{f: jnp.asarray(getattr(gb, f).numpy()) for f in _GB}),
        velocity=None, last_velocity=None, scene_color=None, cam=jm,
        unjittered_cam=jm, prev_cam=jm, frame_index=jnp.int32(3),
        params=params, env=None)
    want, _ = jre.GTAOEffect(resolution_scale=0.5).apply(
        jctx, jnp.asarray(color.numpy()), {})
    tctx = TContext(gbuffer=gb, velocity=None, last_velocity=None,
                    scene_color=None, cam=tm, unjittered_cam=tm, prev_cam=tm,
                    frame_index=3, params=params)
    got, _ = tre.GTAOEffect(resolution_scale=0.5).apply(tctx, color, {})
    _check(got.numpy(), np.asarray(want), (H, W, 3), 0.0)
    full, _ = tre.GTAOEffect().apply(tctx, color, {})
    assert not torch.equal(full, got)
