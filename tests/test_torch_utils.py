"""The port's remaining helpers vs the JAX package, on the CPU.

- ``sample_catmull_rom_5tap`` against the JAX function, plain and
  through float16 storage, on uvs inside and past the frame: equal
  (both read four clamped corners a bilinear tap in the same order; the
  JAX package packs them, which moves no value). Inside the warp window
  it computes the catrom5 window warp's filter: the JAX package's own
  bound there, 1e-4 (the warp sums 12 weighted texels in another order).
- ``write_png`` and ``save_frame`` write the JAX package's bytes, from a
  tensor too; ``read_hdr`` reads flat and run-length scanlines as it
  does.
- ``visualize_gbuffer`` (every mode) and ``visualize_velocity`` equal
  the JAX package's images.
- ``GBuffer.background`` and ``VelocityBuffer.zeros`` run on ``cuda``
  unless the caller asks for another device: without CUDA they raise,
  with ``device="cpu"`` they build.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realism_effects_tpu as jre
from realism_effects_tpu.core import sampling as jsamp
from realism_effects_tpu.core.framebuffers import GBuffer as JG
from realism_effects_tpu.core.framebuffers import VelocityBuffer as JV
from realism_effects_tpu.utils import debug as jdebug
from realism_effects_tpu.utils import image_io as jio
import realism_effects_tpu_torch as tre
from realism_effects_tpu_torch.core import sampling
from realism_effects_tpu_torch.ops import warp
from realism_effects_tpu_torch.utils import debug, image_io


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("channels", [1, 4])
def test_catmull_rom_5tap_matches_jax(half, channels):
    r = np.random.default_rng(channels)
    shape = (24, 40) if channels == 1 else (24, 40, channels)
    tex = r.uniform(0, 3, shape).astype(np.float32)
    uv = r.uniform(-0.05, 1.05, (24, 40, 2)).astype(np.float32)
    got = sampling.sample_catmull_rom_5tap(torch.from_numpy(tex), torch.from_numpy(uv),
                                           half=half)
    want = jsamp.sample_catmull_rom_5tap(jnp.asarray(tex), jnp.asarray(uv), half=half)
    assert got.shape == tex.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_catmull_rom_5tap_is_the_window_filter():
    r = np.random.default_rng(11)
    h, w = 60, 96
    tex = torch.from_numpy(r.standard_normal((h, w, 4)).astype(np.float32))
    base = np.stack(np.meshgrid((np.arange(w) + 0.5) / w, (np.arange(h) + 0.5) / h), -1)
    off = r.uniform(-6.0, 6.0, (h, w, 2)) / np.asarray([w, h])
    uv = torch.from_numpy((base + off).astype(np.float32))
    got, ok = warp.catmull_rom5_window(tex, uv, ky=8)
    assert bool(ok.all())
    want = sampling.sample_catmull_rom_5tap(tex, uv, half=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)


def test_png_and_frame_bytes_match_jax(tmp_path):
    r = np.random.default_rng(2)
    hdr = r.uniform(0, 4, (9, 13, 3)).astype(np.float32)
    cases = [("rgb.png", hdr / 4, {}), ("rgba.png", r.random((5, 7, 4)), {}),
             ("gray.png", r.random((6, 4)), {"flip_v": False}),
             ("u8.png", r.integers(0, 256, (4, 6, 3), dtype=np.uint8), {})]
    for name, img, kw in cases:
        image_io.write_png(str(tmp_path / f"port_{name}"), img, **kw)
        jio.write_png(str(tmp_path / f"jax_{name}"), img, **kw)
        assert (tmp_path / f"port_{name}").read_bytes() == (tmp_path / f"jax_{name}").read_bytes()
    image_io.save_frame(str(tmp_path / "port_frame.png"), torch.from_numpy(hdr))
    jio.save_frame(str(tmp_path / "jax_frame.png"), hdr)
    assert (tmp_path / "port_frame.png").read_bytes() == (tmp_path / "jax_frame.png").read_bytes()
    assert tre.save_frame is image_io.save_frame and tre.write_png is image_io.write_png


def _rgbe(rgb):
    """(H, W, 3) float -> RGBE bytes, the Radiance encoding."""
    m = rgb.max(-1)
    e = np.where(m > 1e-32, np.floor(np.log2(np.maximum(m, 1e-32))) + 1, 0)
    scale = np.where(m > 1e-32, 256.0 / np.exp2(e), 0.0)
    out = np.zeros(rgb.shape[:2] + (4,), np.uint8)
    out[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    out[..., 3] = np.where(m > 1e-32, e + 128, 0).astype(np.uint8)
    return out


def test_read_hdr_matches_jax(tmp_path):
    r = np.random.default_rng(4)
    h, w = 5, 12
    rgbe = _rgbe(r.uniform(0, 8, (h, w, 3)))
    rgbe[1] = rgbe[1, :1]  # a row of one value: a run
    lines = []
    for y in range(h):
        if y % 2:  # new-style run-length scanline: one run or literals a channel
            line = bytes([2, 2, w >> 8, w & 255])
            for c in range(4):
                vals = rgbe[y, :, c]
                if (vals == vals[0]).all():
                    line += bytes([128 + w, int(vals[0])])
                else:
                    line += bytes([w]) + vals.tobytes()
            lines.append(line)
        else:
            lines.append(rgbe[y].tobytes())
    path = tmp_path / "map.hdr"
    path.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                     + f"-Y {h} +X {w}\n".encode() + b"".join(lines))
    got = image_io.read_hdr(str(path))
    assert got.shape == (h, w, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jio.read_hdr(str(path)))
    (tmp_path / "bad.hdr").write_bytes(b"P6\n")
    with pytest.raises(ValueError, match="Radiance"):
        image_io.read_hdr(str(tmp_path / "bad.hdr"))


_GB = ("diffuse", "normal", "roughness", "metalness", "emissive", "depth")


@pytest.mark.parametrize("mode", ["diffuse", "alpha", "normal", "roughness",
                                  "metalness", "emissive", "depth", "mesh_id"])
def test_debug_views_match_jax(mode):
    r = np.random.default_rng(5)
    h, w = 6, 9
    planes = {"diffuse": (4,), "normal": (3,), "roughness": (), "metalness": (),
              "emissive": (3,), "depth": ()}
    arrs = {k: r.random((h, w) + s).astype(np.float32) for k, s in planes.items()}
    mesh_id = r.integers(-1, 5, (h, w)).astype(np.int32)
    gb = tre.GBuffer(**{k: torch.from_numpy(v) for k, v in arrs.items()},
                     mesh_id=torch.from_numpy(mesh_id))
    jgb = JG(**{k: jnp.asarray(v) for k, v in arrs.items()}, mesh_id=jnp.asarray(mesh_id))
    got = debug.visualize_gbuffer(gb, mode)
    want = jdebug.visualize_gbuffer(jgb, mode)
    assert got.shape == (h, w, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)
    if mode == "diffuse":
        vel = r.uniform(-0.1, 0.1, (h, w, 2)).astype(np.float32)
        tv = tre.VelocityBuffer(velocity=torch.from_numpy(vel), normal=gb.normal,
                                depth=gb.depth)
        jv = JV(velocity=jnp.asarray(vel), normal=jgb.normal, depth=jgb.depth)
        np.testing.assert_array_equal(debug.visualize_velocity(tv, 4.0).numpy(),
                                      np.asarray(jdebug.visualize_velocity(jv, 4.0)))
        with pytest.raises(ValueError, match="mode"):
            debug.visualize_gbuffer(gb, "specular")


def test_buffers_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (tre.GBuffer.background, tre.VelocityBuffer.zeros):
        with pytest.raises(RuntimeError, match="CUDA"):
            make(4, 6)
    gb = tre.GBuffer.background(4, 6, device="cpu")
    vel = tre.VelocityBuffer.zeros(4, 6, device="cpu")
    assert gb.device.type == vel.depth.device.type == "cpu"
    assert bool((gb.depth == 1.0).all()) and bool((vel.depth == 1.0).all())
    assert gb.diffuse.shape == (4, 6, 4) and vel.velocity.shape == (4, 6, 2)
