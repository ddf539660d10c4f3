"""``csrc/warp.cu`` ``warp_kernel``: a windowed fetch of a (h, w, c)
texture at per-pixel texels, ``mode`` catrom5, bilinear or nearest
(``chip_smoke.py``'s warp entries). Reads the texture, the int32 texel
rows and columns and, but for nearest, the float32 fractions; writes the
(h, w, c) float32 result and a one-byte flag. Operations a pixel: c x 32
+ 30 (catrom5), 12 + c x 9 (bilinear), c x 2 (nearest)."""

NAME = "warp_kernel"


def cost(p):
    h, w, c, mode = p["h"], p["w"], p["c"], p["mode"]
    px = h * w
    fracs = 0 if mode == "nearest" else 2 * px * 4
    nbytes = px * c * 4 + 2 * px * 4 + fracs + px * c * 4 + px
    per_px = {"catrom5": c * 32 + 30, "bilinear": 12 + c * 9, "nearest": c * 2}[mode]
    return nbytes, px * per_px
