"""``csrc/hbao.cu`` ``hbao_kernel``: horizon-based AO of ``spp`` samples a
pixel. Reads depth (4 B a pixel), normals (12 B) and the 128 x 128
noise table (16 B a texel); writes the AO (4 B). Operations: 61 a pixel
in front of the background and 122 a sample there (a background pixel's
AO is 1 whatever its samples), and 13 a noise texel (``chip_smoke.py``'s
``HBAO_OPS_*``). ``foreground_share`` is the least share of the frame in
front of the background over the cell's motion."""

NAME = "hbao_kernel"


def cost(p):
    h, w, spp = p["h"], p["w"], p["spp"]
    px = h * w
    fg = int(p["foreground_share"] * px)
    nbytes = px * 4 + px * 12 + 128 * 128 * 16 + px * 4
    return nbytes, fg * (61 + spp * 122) + 128 * 128 * 13
