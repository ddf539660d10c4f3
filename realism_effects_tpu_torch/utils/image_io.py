"""Image files with numpy and zlib alone (the JAX package's
``utils/image_io.py``): PNG out, Radiance ``.hdr`` in, and a frame saved
tone-mapped. They stand in for the browser's screenshots and the
reference's ``RGBELoader`` (`example/main.js:748-755`)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def tonemap_aces(rgb: np.ndarray) -> np.ndarray:
    """An ACES-like filmic curve, HDR -> [0, 1]."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    x = np.maximum(rgb, 0.0)
    return np.clip((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def linear_to_srgb(rgb: np.ndarray) -> np.ndarray:
    rgb = np.clip(rgb, 0.0, 1.0)
    return np.where(rgb <= 0.0031308, rgb * 12.92, 1.055 * rgb ** (1 / 2.4) - 0.055)


def write_png(path: str, image: np.ndarray, flip_v: bool = True):
    """Write an (H, W), (H, W, 3) or (H, W, 4) array, float in [0, 1] or
    uint8, as an 8-bit PNG. ``flip_v``: frames are stored with row 0 at
    the bottom (GL), PNG rows go top down."""
    img = np.asarray(image)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if flip_v:
        img = img[::-1]
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def read_hdr(path: str) -> np.ndarray:
    """A Radiance RGBE ``.hdr`` file (``32-bit_rle_rgbe``, flat or
    new-style RLE scanlines, ``-Y H +X W``) as (H, W, 3) float32, row 0
    at the bottom."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("not a Radiance HDR file")
    pos = data.find(b"\n\n")
    if pos < 0:
        raise ValueError("malformed HDR header")
    header = data[:pos].decode("latin-1")
    if "32-bit_rle_rgbe" not in header and "FORMAT" in header:
        raise ValueError("unsupported HDR format")
    pos += 2
    eol = data.find(b"\n", pos)
    dims = data[pos:eol].decode("latin-1").split()
    if len(dims) != 4 or dims[0] != "-Y" or dims[2] != "+X":
        raise ValueError(f"unsupported HDR orientation: {dims}")
    height, width = int(dims[1]), int(dims[3])
    pos = eol + 1

    rgbe = np.zeros((height, width, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8)
    for y in range(height):
        # a new-style RLE scanline starts 0x02 0x02 hi lo
        if (buf[pos] == 2 and buf[pos + 1] == 2
                and (int(buf[pos + 2]) << 8 | int(buf[pos + 3])) == width):
            pos += 4
            for c in range(4):
                x = 0
                while x < width:
                    count = int(buf[pos])
                    pos += 1
                    if count > 128:  # a run
                        rgbe[y, x: x + count - 128, c] = buf[pos]
                        pos += 1
                        x += count - 128
                    else:            # literals
                        rgbe[y, x: x + count, c] = buf[pos: pos + count]
                        pos += count
                        x += count
        else:  # a flat scanline
            rgbe[y] = buf[pos: pos + width * 4].reshape(width, 4)
            pos += width * 4

    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136))
    rgb = rgbe[..., :3].astype(np.float32) * scale[..., None]
    rgb = np.where((exp == 0)[..., None], 0.0, rgb).astype(np.float32)
    return rgb[::-1]  # Radiance stores rows top down (-Y)


def save_frame(path: str, hdr_rgb, tonemap: bool = True):
    """Tone-map (ACES-like) and sRGB-encode an (H, W, 3) frame, an array
    or a tensor on any device, and write it as a PNG."""
    if hasattr(hdr_rgb, "detach"):
        hdr_rgb = hdr_rgb.detach().float().cpu().numpy()
    img = np.asarray(hdr_rgb, np.float32)
    if tonemap:
        img = tonemap_aces(img)
    write_png(path, linear_to_srgb(img))
