"""``csrc/stencil.cu`` ``minmax_kernel``: the (2r + 1)^2 neighbourhood
minimum and maximum of a (h, w, c) float32 texture (TRAA's and the
reprojection's clamp). Reads the texture, writes the two results; two
compares a tap and channel."""

NAME = "minmax_kernel"


def cost(p):
    h, w, c, r = p["h"], p["w"], p["c"], p["r"]
    return 3 * h * w * c * 4, h * w * c * (2 * r + 1) ** 2 * 2
