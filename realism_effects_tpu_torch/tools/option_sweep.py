"""Headless option sweep, the analog of the reference's SSGIDebugGUI /
HBAODebugGUI: the port of the JAX package's ``tools/option_sweep.py``.

The reference exposes every effect option in a tweakpane GUI
(`example/SSGIDebugGUI.js:21-130`) for A/B comparisons. Headless, the
equivalent is a contact sheet: the same scene rendered once per option
value, the converged frames tiled side by side into one PNG.

Usage:
  python -m realism_effects_tpu_torch.tools.option_sweep --effect ssgi \\
      --option distance --values 2,5,10,20 --out sweep.png
  python -m realism_effects_tpu_torch.tools.option_sweep --effect hbao \\
      --option spp --values 2,8,32
  python -m realism_effects_tpu_torch.tools.option_sweep --effect ssgi \\
      --option output_texture --values diffuse,specular,denoised_diffuse,composed

As a library, ``sweep(effect_name, option, values)`` returns the list of
(value, frame) pairs. It runs on ``cuda`` unless ``device="cpu"`` (or
``--device cpu``) is given.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np


def _build_scene(device):
    from .. import (Material, PerspectiveCamera, Scene, build_equirect_env,
                    make_box, make_plane, make_sphere, procedural_sky,
                    translation)

    scene = Scene()
    scene.environment = build_equirect_env(procedural_sky(64, 128), device=device)
    scene.add(make_plane(20, Material(diffuse=(0.6, 0.6, 0.65, 1.0))))
    glow = scene.add(make_box(
        (0.2, 1.6, 2.4),
        Material(diffuse=(1.0, 0.6, 0.3, 1.0), emissive=(5.0, 2.0, 0.8))))
    glow.set_matrix(translation(-1.6, 0.8, 0))
    box = scene.add(make_box((1, 1, 1), Material(diffuse=(0.9, 0.3, 0.2, 1.0))))
    box.set_matrix(translation(0, 0.5, 0))
    ball = scene.add(make_sphere(0.5, material=Material(
        diffuse=(0.2, 0.5, 0.9, 1.0), roughness=0.15, metalness=0.9)))
    ball.set_matrix(translation(1.3, 0.5, 0.6))
    cam = PerspectiveCamera(50, 1, 0.1, 100)
    cam.set_position(3, 2.5, 4)
    cam.look_at((0, 0.5, 0))
    return scene, cam


def _parse_value(text: str):
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            continue
    if text in ("true", "false"):
        return text == "true"
    return text  # a string option (output_texture, denoise_mode)


def sweep(effect_name: str, option: str, values, size: int = 192,
          frames: int = 12, aa: bool = True, device=None):
    """Render the fixture scene once per option value on ``device``
    (``cuda`` unless another device is asked for); returns
    [(value, (H, W, 3) numpy frame), ...]."""
    from .. import (EffectComposer, GTAOEffect, HBAOEffect, MotionBlurEffect,
                    SSGIEffect, SSREffect, TRAAEffect)
    from ..composer import resolve_device

    dev = resolve_device(device)
    effect_table = {
        "ssgi": SSGIEffect, "ssr": SSREffect, "hbao": HBAOEffect,
        "gtao": GTAOEffect, "motion_blur": MotionBlurEffect,
    }
    cls = effect_table[effect_name]
    results = []
    for value in values:
        scene, cam = _build_scene(dev)
        composer = EffectComposer(scene, cam, size, size, device=dev)
        composer.add_effect(cls(**{option: value}))
        if aa:
            composer.add_effect(TRAAEffect())
        img = None
        for _ in range(frames):
            img = composer.render(dt=1 / 60)
        results.append((value, img.detach().cpu().numpy()))
    return results


def contact_sheet(results, out_path: str):
    """Tile the frames horizontally, tone-mapped and sRGB-encoded, with a
    1-pixel white divider, and write the sheet as a PNG."""
    from ..utils.image_io import linear_to_srgb, tonemap_aces, write_png

    tiles = []
    for _value, img in results:
        tile = np.clip(linear_to_srgb(tonemap_aces(np.maximum(img, 0.0))), 0, 1)
        tiles.append(tile)
        tiles.append(np.ones((tile.shape[0], 1, 3), np.float32))  # divider
    sheet = np.concatenate(tiles[:-1], axis=1)
    write_png(out_path, sheet)
    return sheet


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m realism_effects_tpu_torch.tools.option_sweep",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--effect", default="ssgi",
                    choices=["ssgi", "ssr", "hbao", "gtao", "motion_blur"])
    ap.add_argument("--option", required=True)
    ap.add_argument("--values", required=True,
                    help="comma-separated option values")
    ap.add_argument("--size", type=int, default=192)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--no-aa", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch versions")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "option_sweep.png"))
    args = ap.parse_args(argv)

    values = [_parse_value(v) for v in args.values.split(",")]
    results = sweep(args.effect, args.option, values, size=args.size,
                    frames=args.frames, aa=not args.no_aa, device=args.device)
    contact_sheet(results, args.out)
    print(f"{args.effect}.{args.option} sweep over {values} -> {args.out}")


if __name__ == "__main__":
    main()
