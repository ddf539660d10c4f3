"""``csrc/poisson.cu`` ``poisson_kernel``: one Poisson denoise pass over a
(h, w, bundle_c) float32 bundle (the slots and the G-buffer planes they
are weighted by) and the 128 x 128 noise tile, writing (h, w, out_c)
float32. Operations a pixel: 90 of set-up and 8 taps of 45 plus 45 a
slot (``chip_smoke.py``'s ``POISSON_OPS_*``)."""

NAME = "poisson_kernel"


def cost(p):
    h, w = p["h"], p["w"]
    px = h * w
    nbytes = px * p["bundle_c"] * 4 + 128 * 128 * 16 + px * p["out_c"] * 4
    return nbytes, px * (90 + 8 * (45 + p["slots"] * 45))
