"""``csrc/motion_blur.cu`` ``motion_blur_kernel``: motion blur's
accumulate pass, each pixel summing the weighted float16 texels of the
(direction, radius) cells of its own two direction bins. Bytes: 40 a
pixel, each read or written once (the two extents and two bin planes,
16; the pixel's own texel, 8; the float32 RGBA sum, 16; the cell table
travels in the launch's parameters). Operations: 4 a cell walked (min,
subtract, max, zero test) and 8 a cell read (4 fused multiply-adds), as
``chip_smoke.py`` counts them (``MB_OPS_CELL``, ``MB_OPS_READ``); every
pixel walks at least the ``steps`` cells of one bin, while the second
bin's walk and the cells read depend on the velocity and are left
out."""

NAME = "motion_blur_kernel"


def cost(p):
    px = p["h"] * p["w"]
    return 40 * px, px * p["steps"] * 4
