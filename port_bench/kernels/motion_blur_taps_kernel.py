"""``csrc/motion_blur.cu`` ``motion_blur_taps_kernel``: motion blur's
``samples + 1`` bilinear taps, a thread a pixel. Bytes: 32 a pixel, each
read or written once (the float32 RGB colour, which is also the source
the taps read, 12; the velocity, 8; the output, 12), and the 128 x 128
float32 RGBA blue-noise tile once. Operations: 8 a pixel (its uv and the
still test), as ``chip_smoke.py`` counts them (``TAPS_OPS_PIXEL``): a
pixel that does not move takes no tap, so the taps' arithmetic depends
on the velocity and is left out."""

NAME = "motion_blur_taps_kernel"


def cost(p):
    px = p["h"] * p["w"]
    return 32 * px + 128 * 128 * 16, px * 8
