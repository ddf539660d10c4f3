"""The port's paths, as ``chip_smoke.py`` and ``profile_slice.py`` drive
them, with the camera orbiting 0.02 rad a frame (:func:`orbit`, as
``bench.py``'s config 3; its flagship frame orbits 0.01, as the port's
``bench.py`` does):

- the flagship frame (``bench.py:180-207``): ``EffectComposer.render`` of
  a plane, a box and a metallic sphere under the procedural sky, with
  SSGI + HBAO + motion blur + TRAA (:func:`flagship_composer`);
- the reference demo's full stack on the same scene through ``render``:
  SSGI, tone mapping, TRAA, sharpness, vignette, bloom and a grading LUT
  (:func:`demo_stack_composer`);
- the reference's three other effect exports on the same scene through
  ``render``: SSR, GTAO and TAA (:func:`reference_exports_composer`),
  driven as a product viewer is: the camera still for a few frames (TAA
  accumulates), then one orbit step (TAA starts again)
  (:func:`still_then_step`);
- the reference's per-pixel SSGI march under the reference demo's kind
  of environment, a cube map, with SMAA (:func:`march_aa_composer`), and
  SSR's march, HBAO and FXAA under an orthographic camera, a product
  viewer's view (:func:`ortho_ssr_composer`), both through ``render``;
- a loaded asset through ``render``: the flagship scene with a box of
  material alpha 0.5 and a cutout quad under a checker alpha map,
  written to a GLB and loaded back, the alpha box animated by an
  ``AnimationMixer``, rendered with ``msaa=2`` and three alpha peels
  under HBAO and TRAA, the camera still and then one orbit step
  (:func:`gltf_alpha_msaa_composer`);
- analytic input buffers for driving the effect chain through
  ``render_external`` without the rasterizer: a 20 x 20 ground plane at
  y = 0 with a unit box on it (the scene of the JAX package's
  ``tests/test_external_ingestion.py``) and, with ``sphere=True``, the
  flagship's metallic sphere; ray-cast per pixel on the given device.
  HBAO + TRAA runs on them by default (fused) or, inside
  :func:`unfused`, on the JAX package's unfused HBAO and Poisson route.
"""

from __future__ import annotations

import contextlib
import math
import os
import tempfile

import numpy as np
import torch

from .composer import EffectComposer
from .core.camera import OrthographicCamera, PerspectiveCamera
from .core.envmap import build_equirect_env, equirect_to_cube, procedural_sky
from .core.framebuffers import GBuffer, VelocityBuffer
from .core.math3d import uv_grid
from .effects.ao import GTAOEffect, HBAOEffect
from .effects.finishing import SharpnessEffect
from .effects.fxaa import FXAAEffect
from .effects.motion_blur import MotionBlurEffect
from .effects.postfx import (BloomEffect, LUT3DEffect, ToneMappingEffect,
                             VignetteEffect)
from .effects.smaa import SMAAEffect
from .effects.ssgi import SSGIEffect, SSREffect
from .effects.taa import TAAPass
from .effects.traa import TRAAEffect
from .scene.animation import AnimationChannel, AnimationClip, AnimationMixer
from .scene.geometry import (Material, make_box, make_plane, make_sphere,
                             rotation_x, rotation_y, translation)
from .scene.gltf import load_gltf_asset, write_glb
from .scene.scene import Scene

#: the flagship's sphere (``bench.py:193-197``): centre, radius, albedo,
#: roughness, metalness
SPHERE = ((1.5, 0.6, 0.5), 0.6, (0.2, 0.5, 0.9), 0.2, 0.8)


def orbit(cam, f: int):
    """Camera of frame ``f``: radius 4 at height 2.5, 0.02 rad a frame."""
    ang = 0.6 + 0.02 * f
    cam.set_position(4 * math.sin(ang), 2.5, 4 * math.cos(ang))
    cam.look_at((0, 0.5, 0))


def _project(m, p):
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = [float(m[i, 0]) * x + float(m[i, 1]) * y + float(m[i, 2]) * z
         + float(m[i, 3]) for i in range(4)]
    return r[0] / r[3], r[1] / r[3], r[2] / r[3]


def ray_cast(mats, prev_mats, h: int, w: int, device, sphere: bool = False):
    """(GBuffer, VelocityBuffer, scene colour (H, W, 3)) of the scene
    seen through camera ``mats``: depth, world normals (0 on the
    background), velocity = current uv - uv under ``prev_mats``, and a
    Lambert-lit colour. ``sphere`` adds :data:`SPHERE`."""
    uv = uv_grid(h, w, device)
    ndc = torch.stack([(uv[..., 0] - 0.5) * 2.0, (uv[..., 1] - 0.5) * 2.0,
                       torch.ones_like(uv[..., 0])], -1)
    inv_pv = np.linalg.inv(mats.projection_view_matrix.astype(np.float64))
    far = torch.stack(_project(inv_pv, ndc), -1)
    org = torch.tensor(mats.position, dtype=torch.float32, device=device)
    d = far - org
    d = d / d.norm(dim=-1, keepdim=True)
    inf = torch.full_like(d[..., 0], float("inf"))

    # ground plane y = 0, |x|, |z| <= 10
    t_pl = torch.where(d[..., 1] < 0, -org[1] / d[..., 1], inf)
    hit = org + t_pl[..., None] * d
    t_pl = torch.where((hit[..., 0].abs() <= 10) & (hit[..., 2].abs() <= 10),
                       t_pl, inf)
    # box [-0.5, 0.5] x [0, 1] x [-0.5, 0.5] (slabs)
    lo = torch.tensor([-0.5, 0.0, -0.5], device=device)
    hi = torch.tensor([0.5, 1.0, 0.5], device=device)
    t0 = (lo - org) / d
    t1 = (hi - org) / d
    t_near, axis = torch.minimum(t0, t1).max(dim=-1)
    t_far = torch.maximum(t0, t1).min(dim=-1).values
    t_box = torch.where((t_near <= t_far) & (t_near > 0), t_near, inf)

    box = t_box < t_pl
    t = torch.minimum(t_box, t_pl)
    if sphere:
        (cx, cy, cz), rad = SPHERE[0], SPHERE[1]
        oc = org - torch.tensor([cx, cy, cz], device=device)
        b = (oc * d).sum(-1)
        disc = b * b - (float((oc * oc).sum()) - rad * rad)
        t_sph = -b - torch.sqrt(torch.clamp(disc, min=0.0))
        t_sph = torch.where((disc >= 0) & (t_sph > 0), t_sph, inf)
        sph = t_sph < t
        box = box & ~sph
        t = torch.minimum(t, t_sph)
    else:
        sph = torch.zeros_like(box)
    bg = torch.isinf(t)
    p = org + torch.where(bg, 0.0, t)[..., None] * d
    n_box = torch.zeros_like(d).scatter_(
        -1, axis[..., None], -torch.sign(d).gather(-1, axis[..., None]))
    n_pl = torch.zeros_like(d)
    n_pl[..., 1] = 1.0
    normal = torch.where(box[..., None], n_box, n_pl)
    if sphere:
        n_sph = (p - torch.tensor(SPHERE[0], device=device)) / SPHERE[1]
        normal = torch.where(sph[..., None], n_sph, normal)
    normal = torch.where(bg[..., None], 0.0, normal).contiguous()

    _, _, z = _project(mats.projection_view_matrix, p)
    depth = torch.where(bg, 1.0, z * 0.5 + 0.5).contiguous()
    px, py, _ = _project(prev_mats.projection_view_matrix, p)
    prev_uv = torch.stack([px * 0.5 + 0.5, py * 0.5 + 0.5], -1)
    velocity = torch.where(bg[..., None], 0.0, uv - prev_uv).contiguous()

    albedo = torch.where(box[..., None],
                         torch.tensor([0.9, 0.3, 0.2], device=device),
                         torch.tensor([0.6, 0.6, 0.65], device=device))
    albedo = torch.where(sph[..., None], torch.tensor(SPHERE[2], device=device),
                         albedo)
    sun = torch.tensor([0.4, 0.8, 0.45], device=device)
    sun = sun / sun.norm()
    lambert = (normal * sun).sum(-1).clamp(min=0.0)[..., None]
    color = albedo * (0.2 + 1.1 * lambert)
    color = torch.where(bg[..., None],
                        torch.tensor([0.5, 0.7, 0.9], device=device), color)
    gb = GBuffer(
        diffuse=torch.cat([albedo, torch.ones_like(depth)[..., None]], -1),
        normal=normal,
        roughness=torch.where(sph, SPHERE[3], torch.where(box, 0.4, 0.8)),
        metalness=torch.where(sph, SPHERE[4], 0.0),
        emissive=torch.zeros_like(d),
        depth=depth)
    vel = VelocityBuffer(velocity=velocity, normal=normal, depth=depth)
    return gb, vel, color.contiguous()


def frames_at(cam, steps, h: int, w: int, device, sphere: bool = False):
    """Buffers of frames with the camera at orbit indices ``steps``, one a
    frame (``range(first, first + n)`` for the orbiting camera,
    :func:`still_then_step` for one that holds still, then moves); the
    first frame's previous camera one orbit step before its own."""
    orbit(cam, steps[0] - 1)
    prev = cam.matrices()
    out = []
    for f in steps:
        orbit(cam, f)
        mats = cam.matrices()
        out.append(ray_cast(mats, prev, h, w, device, sphere=sphere))
        prev = mats
    return out


def still_then_step(first: int, n: int, still: int) -> list[int]:
    """Orbit indices of frames ``first .. first + n - 1`` of a camera that
    holds still for the first ``still`` frames, then takes one orbit step
    (0.02 rad) and holds still again: 0, then 1."""
    return [0 if f < still else 1 for f in range(first, first + n)]


def hbao_traa_composer(h: int, w: int, device):
    """``EffectComposer`` with ``HBAOEffect()`` + ``TRAAEffect()`` and its
    camera."""
    cam = PerspectiveCamera(50, w / h, 0.1, 100)
    comp = EffectComposer(None, cam, w, h, device=device)
    comp.add_effect(HBAOEffect())
    comp.add_effect(TRAAEffect())
    return comp, cam


def ssgi_hbao_traa_composer(h: int, w: int, device):
    """``EffectComposer`` with ``SSGIEffect()`` + ``HBAOEffect()`` +
    ``TRAAEffect()`` under the flagship's environment,
    ``build_equirect_env(procedural_sky(64, 128))`` (``bench.py:189``),
    and its camera."""
    cam = PerspectiveCamera(50, w / h, 0.1, 100)
    scene = Scene()   # render_external reads only its environment
    scene.environment = build_equirect_env(procedural_sky(64, 128), device=device)
    comp = EffectComposer(scene, cam, w, h, device=device)
    comp.add_effect(SSGIEffect())
    comp.add_effect(HBAOEffect())
    comp.add_effect(TRAAEffect())
    return comp, cam


def run_frames(comp, cam, frames, steps):
    """Render ``frames`` (from :func:`frames_at`) with the camera at the
    same orbit indices ``steps``; returns the images."""
    images = []
    for (gb, vel, color), f in zip(frames, steps, strict=True):
        orbit(cam, f)
        images.append(comp.render_external(gb, vel, color, dt=1 / 60))
    return images


def flagship_meshes(plane: float = 20) -> list:
    """The flagship's meshes (``bench.py:190-197``): a ``plane`` x
    ``plane`` ground plane, a unit box on it and the metallic sphere of
    :data:`SPHERE` (734 triangles); ``bench.py``'s staged configurations
    take a plane of 24 (``bench.py:293-310``)."""
    box = make_box((1, 1, 1), Material(diffuse=(0.9, 0.3, 0.2, 1.0)))
    box.set_matrix(translation(0, 0.5, 0))
    (cx, cy, cz), rad, albedo, rough, metal = SPHERE
    sph = make_sphere(rad, material=Material(
        diffuse=albedo + (1.0,), roughness=rough, metalness=metal))
    sph.set_matrix(translation(cx, cy, cz))
    return [make_plane(plane, Material(diffuse=(0.6, 0.6, 0.65, 1.0))), box, sph]


def flagship_scene(device, meshes=None) -> Scene:
    """The flagship scene of ``bench.py:188-197``: ``meshes`` (by default
    :func:`flagship_meshes`) under
    ``build_equirect_env(procedural_sky(64, 128))``."""
    scene = Scene()
    scene.environment = build_equirect_env(procedural_sky(64, 128), device=device)
    for mesh in flagship_meshes() if meshes is None else meshes:
        scene.add(mesh)
    return scene


def flagship_composer(h: int, w: int, device):
    """``EffectComposer.render`` of :func:`flagship_scene` with the
    flagship stack of ``bench.py:201-206``: ``SSGIEffect()`` +
    ``HBAOEffect()`` + ``MotionBlurEffect()`` (sweep) + ``TRAAEffect()``,
    and its camera."""
    cam = PerspectiveCamera(50, w / h, 0.1, 100)
    comp = EffectComposer(flagship_scene(device), cam, w, h, device=device)
    comp.add_effect(SSGIEffect())
    comp.add_effect(HBAOEffect())
    comp.add_effect(MotionBlurEffect())
    comp.add_effect(TRAAEffect())
    return comp, cam


def flagship_march_composer(h: int, w: int, device):
    """:func:`flagship_composer` with upstream's per-pixel stack:
    ``SSGIEffect(trace="march")`` and ``MotionBlurEffect(mode="taps")``."""
    comp, cam = flagship_composer(h, w, device)
    comp.effects = []
    for effect in (SSGIEffect(trace="march"), HBAOEffect(), MotionBlurEffect(mode="taps"),
                   TRAAEffect()):
        comp.add_effect(effect)
    return comp, cam


def render_frames(comp, cam, steps, mixer=None):
    """``comp.render(dt=1/60)`` of a frame at each orbit index of
    ``steps`` (``range(first, first + n)`` or :func:`still_then_step`);
    returns the images. ``mixer``, an ``AnimationMixer`` (that of
    :func:`gltf_alpha_msaa_composer`), is advanced by 1/60 s before each
    frame."""
    images = []
    for f in steps:
        orbit(cam, f)
        if mixer is not None:
            mixer.update(1 / 60)
        images.append(comp.render(dt=1 / 60))
    return images


def reference_exports_composer(h: int, w: int, device):
    """``EffectComposer.render`` of :func:`flagship_scene` (under
    ``procedural_sky(64, 128)``) with the reference's three other effect
    exports at their defaults: ``SSREffect()`` -> ``GTAOEffect()`` ->
    ``TAAPass()``; and its camera. Drive it with :func:`still_then_step`."""
    cam = PerspectiveCamera(50, w / h, 0.1, 100)
    comp = EffectComposer(flagship_scene(device), cam, w, h, device=device)
    for effect in (SSREffect(), GTAOEffect(), TAAPass()):
        comp.add_effect(effect)
    return comp, cam


def march_aa_composer(h: int, w: int, device):
    """``EffectComposer.render`` of :func:`flagship_scene` under a cube
    map, the six (64, 64, 3) faces of ``procedural_sky(64, 128)`` made by
    ``equirect_to_cube`` (the composer turns them back into a 128 x 256
    equirect with ``cube_to_equirect``), with ``SSGIEffect(trace="march")``
    -> ``SMAAEffect()``; and its camera."""
    cam = PerspectiveCamera(50, w / h, 0.1, 100)
    scene = flagship_scene(device)
    sky = torch.as_tensor(procedural_sky(64, 128), device=device)
    scene.environment = equirect_to_cube(sky, 64)
    comp = EffectComposer(scene, cam, w, h, device=device)
    comp.add_effect(SSGIEffect(trace="march"))
    comp.add_effect(SMAAEffect())
    return comp, cam


#: the alpha box's keyframes: it slides along x and back in 2 s
ALPHA_BOX_TRACK = ((0.0, 1.0, 2.0), ((-1.2, 0.5, 1.2), (-0.4, 0.5, 1.2),
                                     (-1.2, 0.5, 1.2)))


def alpha_asset_meshes():
    """The meshes of :func:`gltf_alpha_msaa_composer`'s asset: the
    flagship's plane, box and sphere, a box of material alpha 0.5 (with
    a white base map and an alpha map of ones, so ``write_glb`` writes
    it ``BLEND``) and a 1.2 x 1.2 quad standing in front of it whose
    alpha map is a 64 x 64 checker of 0 and 1 (8-texel squares) in the
    green channel, under a white base map of the same size."""
    meshes = flagship_meshes()
    white = np.ones((8, 8, 4), np.float32)
    box = make_box((0.8, 0.8, 0.8), Material(diffuse=(0.3, 0.6, 0.9, 0.5),
                                             map=white, alpha_map=white))
    box.set_matrix(translation(*ALPHA_BOX_TRACK[1][0]))
    checker = np.ones((64, 64, 4), np.float32)
    yy, xx = np.mgrid[0:64, 0:64]
    checker[..., 1] = ((yy // 8 + xx // 8) % 2).astype(np.float32)
    quad = make_plane(1.2, Material(diffuse=(0.9, 0.8, 0.3, 1.0),
                                    map=np.ones_like(checker), alpha_map=checker,
                                    roughness=0.6))
    quad.set_matrix(translation(0.6, 0.8, 1.6) @ rotation_y(0.6)
                    @ rotation_x(math.pi / 2))
    return meshes + [box, quad]


def gltf_alpha_msaa_composer(h: int, w: int, device):
    """``EffectComposer.render`` of a loaded, animated asset with
    stochastic alpha and MSAA: :func:`alpha_asset_meshes` written by
    ``write_glb`` to a temporary GLB and read back by
    ``load_gltf_asset``; a clip built in code, one ``translation``
    channel on the alpha box's node (:data:`ALPHA_BOX_TRACK`), appended
    to ``asset.animations`` and played by an ``AnimationMixer``; the
    scene under ``procedural_sky(64, 128)``, in an
    ``EffectComposer(..., msaa=2, alpha_peels=3)`` with ``HBAOEffect()``
    -> ``TRAAEffect()``. Returns the composer, its camera and the mixer:
    drive them with ``render_frames(comp, cam, steps, mixer)`` over
    :func:`still_then_step`, whose still frames ramp the alpha law's
    cnmf and whose step gives the first still frame's hard cut."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "alpha_asset.glb")
        write_glb(alpha_asset_meshes(), path)
        asset = load_gltf_asset(path)
    node = len(asset.meshes) - 2          # write_glb: a node a mesh, in order
    times, values = ALPHA_BOX_TRACK
    asset.animations.append(AnimationClip(name="slide", channels=[AnimationChannel(
        node=node, path="translation", times=np.asarray(times, np.float64),
        values=np.asarray(values, np.float64))]))
    mixer = AnimationMixer(asset)
    mixer.clip_action(asset.animations[-1]).play()
    scene = Scene()
    scene.environment = build_equirect_env(procedural_sky(64, 128), device=device)
    for mesh in asset.meshes:
        scene.add(mesh)
    cam = PerspectiveCamera(50, w / h, 0.1, 100)
    comp = EffectComposer(scene, cam, w, h, device=device, msaa=2, alpha_peels=3)
    comp.add_effect(HBAOEffect())
    comp.add_effect(TRAAEffect())
    return comp, cam, mixer


def ortho_camera(h: int, w: int) -> OrthographicCamera:
    """An orthographic camera that frames the flagship scene from the
    orbit: 4 x 4 world units high, the frame's aspect wide."""
    half_w = 2.0 * w / h
    return OrthographicCamera(-half_w, half_w, 2.0, -2.0, 0.1, 100)


def ortho_ssr_composer(h: int, w: int, device):
    """``EffectComposer.render`` of :func:`flagship_scene` under
    :func:`ortho_camera` with ``SSREffect(trace="march")`` ->
    ``HBAOEffect()`` -> ``FXAAEffect()``; and its camera."""
    cam = ortho_camera(h, w)
    comp = EffectComposer(flagship_scene(device), cam, w, h, device=device)
    for effect in (SSREffect(trace="march"), HBAOEffect(), FXAAEffect()):
        comp.add_effect(effect)
    return comp, cam


def demo_lut(size: int = 32) -> np.ndarray:
    """An (S, S, S, 3) float32 grading cube built in code, indexed
    ``lut[r, g, b]``, of the size of the reference demo's ``lut_v2.3dl``:
    an S-curve per channel, lifted blacks, a warm tint and some
    cross-talk between channels, so that the trilinear fetch mixes
    eight distinct texels."""
    x = np.linspace(0.0, 1.0, size)
    r, g, b = np.meshgrid(x, x, x, indexing="ij")
    s_curve = lambda t: t * t * (3.0 - 2.0 * t)
    out = np.stack([
        0.02 + 0.96 * (0.7 * s_curve(r) + 0.3 * r ** 0.8),
        0.01 + 0.97 * (0.5 * s_curve(g) + 0.5 * g) + 0.02 * (r - b),
        0.03 + 0.9 * b ** 1.1 + 0.03 * g,
    ], axis=-1)
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def demo_stack_composer(h: int, w: int, device):
    """``EffectComposer.render`` of :func:`flagship_scene` with the
    reference demo's full stack in its order (``examples/demo.py:264``,
    `main.js:510-539`): ``SSGIEffect()`` -> ``ToneMappingEffect()`` ->
    ``TRAAEffect()`` -> ``SharpnessEffect()`` -> ``VignetteEffect()`` ->
    ``BloomEffect()`` -> ``LUT3DEffect(demo_lut())``; and its camera."""
    cam = PerspectiveCamera(50, w / h, 0.1, 100)
    comp = EffectComposer(flagship_scene(device), cam, w, h, device=device)
    for effect in (SSGIEffect(), ToneMappingEffect(), TRAAEffect(),
                   SharpnessEffect(), VignetteEffect(), BloomEffect(),
                   LUT3DEffect(demo_lut())):
        comp.add_effect(effect)
    return comp, cam


@contextlib.contextmanager
def unfused():
    """Run HBAO and the Poisson denoiser on the JAX package's unfused
    route (``ops.ao.USE_FUSED_KERNEL`` and
    ``ops.poisson_kernel.USE_FUSED_PASS`` off) inside the block; the
    switches are restored after it."""
    from .ops import ao, poisson_kernel

    saved = ao.USE_FUSED_KERNEL, poisson_kernel.USE_FUSED_PASS
    ao.USE_FUSED_KERNEL = poisson_kernel.USE_FUSED_PASS = False
    try:
        yield
    finally:
        ao.USE_FUSED_KERNEL, poisson_kernel.USE_FUSED_PASS = saved
