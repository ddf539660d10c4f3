"""``csrc/sweep.cu`` ``sweep_kernel``: SSGI's direction-binned march of
``rays`` rays a pixel. Reads the float32 depth plane, the float16 RGBA
radiance and ``planes`` float32 planes of per-ray set-up; writes a ray's
hit flag (1 B), three float32 planes and a float16 RGBA sample. The step
table (a few KB) is left out. Operations: 10 a ray; the steps a ray
walks (25 each) depend on the depth and are left out."""

NAME = "sweep_kernel"


def cost(p):
    h, w, rays = p["h"], p["w"], p["rays"]
    px = h * w
    nbytes = px * 4 + px * 8 + p["planes"] * px * 4 + rays * px * (1 + 3 * 4 + 8)
    return nbytes, px * rays * 10
