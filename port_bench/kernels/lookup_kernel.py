"""``csrc/table.cu`` ``lookup_kernel``: the record fetch of a (rows, 128,
k) float32 face table at each pixel's int32 face id, writing (h, w, k)
float32 (the G-buffer's 24-float and the velocity's 30-float records)."""

NAME = "lookup_kernel"


def cost(p):
    h, w, k = p["h"], p["w"], p["k"]
    return p["rows"] * 128 * k * 4 + h * w * 4 + h * w * k * 4, 0
