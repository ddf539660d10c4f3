"""``csrc/raster.cu`` ``zscan_kernel``: the opaque z-scan of a
``triangles`` x ``row`` float32 table at (h, w), writing each pixel's
winning id (int32) and depth (float32). Its 35 operations a (pixel,
triangle whose box holds the pixel) depend on the geometry and are left
out: the bytes bound it (``chip_smoke.py``)."""

NAME = "zscan_kernel"


def cost(p):
    return p["triangles"] * p["row"] * 4 + p["h"] * p["w"] * 8, 0
