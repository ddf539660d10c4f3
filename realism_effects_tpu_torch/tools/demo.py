"""Demo and integration harness: the port of the JAX package's
``examples/demo.py``.

The analog of the reference's example app (`example/main.js`): named
scenes (among them the TRAA torture scene the reference loads with
``?traa_test`` and the AO inspection scene of ``?ao``), a configurable
effect stack, per-frame timing (the `stats-gl` analog) and PNG frames.
It runs on ``cuda`` unless ``--device cpu`` is given, and raises when
CUDA is absent and the CPU was not asked for.

Usage:
  python -m realism_effects_tpu_torch.tools.demo --scene showcase \\
      --frames 60 --size 512 --effects ssgi,hbao --out demo_out
  python -m realism_effects_tpu_torch.tools.demo --scene traa_test --aa traa
  python -m realism_effects_tpu_torch.tools.demo --scene ao --effects hbao
  python -m realism_effects_tpu_torch.tools.demo --scene lights --size 64 \\
      --frames 3 --device cpu

The ``sponza`` scene and the ``lut`` effect read the reference
project's example assets (``example/public/...`` of a checkout of
0beqz/realism-effects: the directory ``REALISM_EFFECTS_REFERENCE`` names,
by default ``reference/`` inside this repository, which git ignores);
without them they fail as the JAX demo does.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch


def reference_dir() -> str:
    """The reference project's checkout: the directory
    ``REALISM_EFFECTS_REFERENCE`` names, by default ``reference/`` inside
    this repository."""
    return os.environ.get("REALISM_EFFECTS_REFERENCE", os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "reference"))


_REFERENCE = reference_dir()
SPONZA = os.path.join(_REFERENCE, "example", "public", "gltf",
                      "sponza_no_textures.optimized.glb")
LUT_3DL = os.path.join(_REFERENCE, "example", "public", "lut_v2.3dl")


def build_scene(name: str, device=None):
    """(scene, camera, animate) of scene ``name``; ``animate(frame)``
    moves the scene for frame ``frame`` (None for a still scene). The
    environment is built on ``device`` (``cuda`` unless another device
    is asked for)."""
    from .. import (Material, PerspectiveCamera, Scene, build_equirect_env,
                    make_box, make_plane, make_sphere, procedural_sky,
                    rotation_y, translation)
    from ..composer import resolve_device

    dev = resolve_device(device)
    scene = Scene()
    scene.environment = build_equirect_env(procedural_sky(64, 128), device=dev)

    if name == "showcase":
        scene.sun_intensity = 1.2
        # checkered albedo map exercises the textured-material path
        yy, xx = np.meshgrid(np.arange(128), np.arange(128), indexing="ij")
        check = (((yy // 16) + (xx // 16)) % 2).astype(np.float32)
        floor_tex = np.stack([0.55 + 0.25 * check] * 3, -1)
        scene.add(make_plane(24, Material(diffuse=(1.0, 1.0, 1.0, 1.0),
                                          roughness=0.85, map=floor_tex)))
        panel = scene.add(make_box((0.2, 2, 2), Material(
            diffuse=(1.0, 0.2, 0.1, 1.0), emissive=(10.0, 1.2, 0.5))))
        panel.set_matrix(translation(-1.5, 1.0, 0))
        wall = scene.add(make_box((0.2, 2, 2), Material(
            diffuse=(0.85, 0.85, 0.85, 1.0))))
        wall.set_matrix(translation(1.5, 1.0, 0))
        ball = scene.add(make_sphere(0.5, material=Material(
            diffuse=(0.9, 0.9, 0.9, 1.0), roughness=0.12, metalness=0.9)))
        ball.set_matrix(translation(0, 0.5, 1.2))
        cam = PerspectiveCamera(50, 1, 0.1, 100)
        cam.set_position(0.5, 1.8, 5)
        cam.look_at((0, 1.0, 0))
        animate = None

    elif name == "traa_test":
        # AA torture: fans of thin rotated slats (`main.js:814-947` analog)
        scene.add(make_plane(30, Material(diffuse=(0.55, 0.55, 0.6, 1.0))))
        for i in range(24):
            slat = scene.add(make_box((0.02, 1.8, 0.02), Material(
                diffuse=(0.9, 0.85, 0.2, 1.0))))
            ang = i / 24 * np.pi
            m = translation(np.cos(ang) * 2, 0.9, np.sin(ang) * 2) @ rotation_y(ang)
            slat.set_matrix(m)
        for i in range(10):
            bar = scene.add(make_box((4.0, 0.015, 0.015), Material(
                diffuse=(0.2, 0.8, 0.9, 1.0))))
            bar.set_matrix(translation(0, 0.2 + 0.18 * i, -2.0))
        cam = PerspectiveCamera(50, 1, 0.1, 100)
        cam.set_position(3.5, 2.2, 4.5)
        cam.look_at((0, 0.8, 0))
        animate = None

    elif name == "ao":
        # columned room (Sponza-ish AO inspection, `main.js:299-302` analog)
        scene.add(make_plane(20, Material(diffuse=(0.7, 0.68, 0.62, 1.0))))
        for ix in range(-2, 3):
            for iz in (-1.5, 1.5):
                col = scene.add(make_box((0.4, 3.0, 0.4), Material(
                    diffuse=(0.72, 0.7, 0.66, 1.0))))
                col.set_matrix(translation(ix * 1.6, 1.5, iz))
        roof = scene.add(make_box((8.0, 0.3, 4.4), Material(
            diffuse=(0.7, 0.68, 0.64, 1.0))))
        roof.set_matrix(translation(0, 3.1, 0))
        cam = PerspectiveCamera(55, 1, 0.1, 100)
        cam.set_position(4.5, 1.7, 4.5)
        cam.look_at((0, 1.4, 0))
        animate = None

    elif name == "lights":
        # shading showcase: dim sun + GGX specular + coloured three.js-style
        # point lights (`scene.add_point_light`)
        scene.environment = build_equirect_env(
            procedural_sky(64, 128) * 0.15, device=dev)
        scene.sun_intensity = 0.35
        scene.sun_specular = 1.0
        scene.add(make_plane(24, Material(diffuse=(0.5, 0.5, 0.55, 1.0),
                                          roughness=0.3, metalness=0.1)))
        for i, (col, rough) in enumerate([((0.9, 0.3, 0.2), 0.15),
                                          ((0.85, 0.85, 0.9), 0.45),
                                          ((0.3, 0.5, 0.9), 0.8)]):
            ball = scene.add(make_sphere(0.5, material=Material(
                diffuse=(*col, 1.0), roughness=rough, metalness=0.2)))
            ball.set_matrix(translation(-1.6 + 1.6 * i, 0.5, 0))
        pillar = scene.add(make_box((0.5, 2.2, 0.5), Material(
            diffuse=(0.8, 0.78, 0.72, 1.0), roughness=0.6)))
        pillar.set_matrix(translation(0, 1.1, -2.0))
        scene.add_point_light((-2.2, 1.6, 1.8), color=(1.0, 0.35, 0.15),
                              intensity=6.0, distance=8.0)
        scene.add_point_light((2.2, 1.2, 1.2), color=(0.2, 0.5, 1.0),
                              intensity=5.0, distance=8.0)
        scene.add_point_light((0.0, 2.6, -0.8), color=(1.0, 0.95, 0.8),
                              intensity=3.0)
        cam = PerspectiveCamera(50, 1, 0.1, 100)
        cam.set_position(0.4, 1.9, 4.6)
        cam.look_at((0, 0.7, -0.3))
        animate = None

    elif name == "gltf":
        # asset pipeline: a GLB written by write_glb and loaded back through
        # the glTF loader (`example/main.js:760-809` analog)
        from ..scene.gltf import load_gltf, write_glb

        checker = np.ones((32, 32, 4), np.float32)
        yy, xx = np.mgrid[0:32, 0:32]
        checker[..., :3] = np.where(
            (((xx // 8) + (yy // 8)) % 2 == 0)[..., None], 0.85, 0.3)
        plane = make_plane(16, Material(diffuse=(1, 1, 1, 1), map=checker))
        box = make_box((1, 1, 1), Material(
            diffuse=(0.9, 0.3, 0.2, 1.0), roughness=0.4))
        box.set_matrix(translation(0, 0.5, 0))
        ball = make_sphere(0.6, material=Material(
            diffuse=(0.2, 0.5, 0.9, 1.0), roughness=0.15, metalness=0.9))
        ball.set_matrix(translation(1.5, 0.6, 0.4))
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "demo.glb")
            write_glb([plane, box, ball], path)
            for m in load_gltf(path):
                scene.add(m)
        cam = PerspectiveCamera(50, 1, 0.1, 100)
        cam.set_position(3, 2.5, 4)
        cam.look_at((0, 0.5, 0))
        animate = None

    elif name == "sponza" or name.startswith("asset:"):
        # the reference's `?ao` inspection scene (`main.js:299-302` loads
        # gltf/sponza...glb), or any glTF via `asset:<path>`; Draco meshes
        # decode through scene/draco.py
        from ..scene.animation import AnimationMixer
        from ..scene.gltf import load_gltf_asset

        path = SPONZA if name == "sponza" else name.split(":", 1)[1]
        asset = load_gltf_asset(path)
        for m in asset.meshes:
            scene.add(m)
        scene.sun_intensity = 1.4
        corners = []
        for m in scene.visible_meshes():
            p = m.positions
            if m.skin_indices is not None and m.bone_matrices is not None:
                bm = m.bone_matrices[m.skin_indices]
                w = m.skin_weights[:, :, None, None]
                sk = (bm * w).sum(1)
                p = np.einsum("vij,vj->vi", sk[:, :3, :3], p) + sk[:, :3, 3]
            lo8, hi8 = p.min(0), p.max(0)
            box = np.array([[x, y, z] for x in (lo8[0], hi8[0])
                            for y in (lo8[1], hi8[1])
                            for z in (lo8[2], hi8[2])])
            mw = np.asarray(m.matrix_world)
            corners.append(box @ mw[:3, :3].T + mw[:3, 3])
        corners = np.concatenate(corners)
        lo, hi = corners.min(0), corners.max(0)
        center = (lo + hi) / 2
        extent = float((hi - lo).max())
        cam = PerspectiveCamera(55, 1, max(extent / 400, 1e-3), extent * 6)
        if name == "sponza":
            cam.set_position(8.0, 2.2, -0.5)
            cam.look_at((-6.0, 3.0, 0.0))
        else:
            cam.set_position(*(center + (hi - lo) * [0.8, 0.45, 1.3]))
            cam.look_at(tuple(center))
        animate = None
        if asset.animations:
            # every clip plays, advanced at the frame rate (the reference's
            # mixer loop, `main.js:949-957,629-632`)
            mixer = AnimationMixer(asset)
            for clip in asset.animations:
                mixer.clip_action(clip).play()

            def animate(frame: int):
                mixer.set_time(frame / 60.0)

    elif name == "dynamic":
        scene.add(make_plane(24, Material(diffuse=(0.6, 0.6, 0.65, 1.0))))
        box = scene.add(make_box((1, 1, 1), Material(
            diffuse=(0.9, 0.3, 0.2, 1.0), roughness=0.4)))
        box.set_matrix(translation(0, 0.5, 0))
        ball = scene.add(make_sphere(0.5, material=Material(
            diffuse=(0.2, 0.5, 0.9, 1.0), roughness=0.2, metalness=0.8)))
        ball.set_matrix(translation(1.5, 0.5, 0.5))
        cam = PerspectiveCamera(50, 1, 0.1, 100)

        def animate(frame: int):
            t = frame / 60.0
            box.set_matrix(
                translation(np.sin(t * 2.5) * 1.2, 0.5, 0) @ rotation_y(t * 3))
            ang = 0.6 + t * 0.6
            cam.set_position(4 * np.sin(ang), 2.5, 4 * np.cos(ang))
            cam.look_at((0, 0.5, 0))

        animate(0)
    else:
        raise SystemExit(f"unknown scene {name!r}")

    return scene, cam, animate


def build_effects(names, aa: str, trace: str = "march"):
    """The effects of the comma-separated ``names`` (or ``["full"]``, the
    reference demo's stack) followed by the ``aa`` pass."""
    from .. import (BloomEffect, FXAAEffect, GradualBackgroundEffect,
                    GTAOEffect, HBAOEffect, LensDistortionEffect, LUT3DEffect,
                    MotionBlurEffect, SharpnessEffect, SMAAEffect,
                    SparkleEffect, SSGIEffect, SSREffect, TAAPass,
                    ToneMappingEffect, TRAAEffect, VignetteEffect,
                    load_lut_3dl)

    def lut():
        if not os.path.exists(LUT_3DL):
            raise SystemExit(f"lut effect needs {LUT_3DL}")
        return LUT3DEffect(load_lut_3dl(LUT_3DL))

    table = {
        "ssgi": lambda: SSGIEffect(trace=trace),
        "ssr": lambda: SSREffect(trace=trace),
        "hbao": lambda: HBAOEffect(),
        "gtao": lambda: GTAOEffect(),
        "motion_blur": lambda: MotionBlurEffect(
            mode="sweep" if trace == "sweep" else "taps"),
        "sharpness": lambda: SharpnessEffect(),
        "sparkle": lambda: SparkleEffect(),
        "lens_distortion": lambda: LensDistortionEffect(),
        "gradual_background": lambda: GradualBackgroundEffect((0.1, 0.12, 0.18)),
        "tonemap": lambda: ToneMappingEffect(),
        "vignette": lambda: VignetteEffect(),
        "bloom": lambda: BloomEffect(),
        "lut": lut,
        "traa": lambda: TRAAEffect(),
        "taa": lambda: TAAPass(),
        "fxaa": lambda: FXAAEffect(),
        "smaa": lambda: SMAAEffect(),
    }
    if names == ["full"]:
        # the reference demo's stack and order (`main.js:510-539`):
        # ssgi+tonemap / traa / sharpness+vignette / bloom+lut
        names = ["ssgi", "tonemap", aa, "sharpness", "vignette", "bloom", "lut"]
        # "none" adds nothing; "msaa" is a composer option, not a pass
        names = [n for n in names if n not in ("none", "msaa")]
        aa = "inline"
    effects = [table[n.strip()]() for n in names if n.strip()]
    if aa == "traa":
        effects.append(TRAAEffect())
    elif aa == "taa":
        effects.append(TAAPass())
    elif aa == "fxaa":
        effects.append(FXAAEffect())
    elif aa == "smaa":
        effects.append(SMAAEffect())
    # "msaa" adds no post pass: it is the composer's supersampled raster
    # (EffectComposer(msaa=2)), set up in run()
    return effects


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m realism_effects_tpu_torch.tools.demo",
        description="Render a named scene through an effect stack and "
                    "write PNG frames.")
    ap.add_argument("--scene", default="showcase",
                    help="showcase | traa_test | ao | lights | gltf | "
                         "dynamic | sponza | asset:<path-to-glb>")
    ap.add_argument("--effects", default="ssgi,hbao")
    ap.add_argument("--aa", default="traa",
                    choices=["traa", "taa", "fxaa", "smaa", "msaa", "none"],
                    help="anti-aliasing; 'msaa' = the composer's 2x2 "
                         "supersampled raster resolve (the reference demo's "
                         "multisampling branch, main.js:116-154)")
    ap.add_argument("--trace", default="march", choices=["march", "sweep"],
                    help="'march' = the reference's per-pixel march; "
                         "'sweep' = the direction-binned sweep "
                         "(ops/ssgi_sweep.py)")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "re_torch_demo"))
    ap.add_argument("--save-every", type=int, default=0,
                    help="write every Nth frame (0 = the final one only)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch versions")
    ap.add_argument("--env", default=None,
                    help="environment: an .hdr file or a cube-map directory "
                         "of posx/negx/... faces (reference: `main.js:278` "
                         "loads hdr/spree_bank_1k.hdr); an optional "
                         "':blur=<0..1>' suffix prefilters it")
    return ap


def make_composer(args):
    """(composer, animate, tonemap_at_save) for ``args``: the scene, its
    environment (``--env``), the composer at ``--size`` (2x2 MSAA for
    ``--aa msaa``) and the effect stack on ``--device``."""
    from .. import EffectComposer, ToneMappingEffect
    from ..composer import resolve_device

    dev = resolve_device(args.device)
    scene, cam, animate = build_scene(args.scene, dev)
    if args.env:
        from ..core.envmap import blur_env, build_equirect_env, load_cubemap
        from ..utils.image_io import read_hdr

        env_path, _, blur = args.env.partition(":blur=")
        eq = (load_cubemap(env_path, device=dev) if os.path.isdir(env_path)
              else torch.as_tensor(read_hdr(env_path), device=dev))
        if blur:
            eq = blur_env(eq, float(blur))
        scene.environment = build_equirect_env(eq.cpu().numpy(), device=dev)
    composer = EffectComposer(scene, cam, args.size, args.size, device=dev,
                              msaa=2 if args.aa == "msaa" else 1)
    effects = build_effects(args.effects.split(","), args.aa, args.trace)
    for e in effects:
        composer.add_effect(e)
    # a ToneMappingEffect in the chain already made display values: no
    # second tone map at save time
    tonemap_at_save = not any(isinstance(e, ToneMappingEffect) for e in effects)
    return composer, animate, tonemap_at_save


def run(args, dt: float | None = None) -> dict:
    """Render ``args.frames`` frames; writes ``final.png`` (and every
    ``--save-every``-th frame) under ``args.out``. ``dt``: the frame time
    the effects see (default: the wall clock between frames, as the
    command line runs). Returns the per-frame host times (ms), the steady
    median and the final frame; no other frame is kept."""
    from .. import save_frame

    composer, animate, tonemap_at_save = make_composer(args)
    dev = composer.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    os.makedirs(args.out, exist_ok=True)
    times = []
    img = None
    for f in range(args.frames):
        if animate:
            animate(f)
        t0 = time.perf_counter()
        img = composer.render(dt=dt)
        sync()
        times.append((time.perf_counter() - t0) * 1000)
        if args.save_every and f % args.save_every == 0:
            save_frame(os.path.join(args.out, f"frame_{f:04d}.png"), img,
                       tonemap=tonemap_at_save)

    save_frame(os.path.join(args.out, "final.png"), img, tonemap=tonemap_at_save)
    steady = times[2:] if len(times) > 4 else times
    return {"times_ms": times, "steady_ms": float(np.median(steady)),
            "image": img}


def main(argv=None):
    args = parser().parse_args(argv)
    res = run(args)
    steady = res["steady_ms"]
    print(f"scene={args.scene} effects={args.effects}+{args.aa} "
          f"size={args.size} frames={args.frames}: "
          f"first {res['times_ms'][0]:.0f} ms, steady median {steady:.2f} ms "
          f"({1000.0 / max(steady, 1e-6):.0f} fps) -> {args.out}/final.png")
    return res


if __name__ == "__main__":
    main()
