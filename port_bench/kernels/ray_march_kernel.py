"""``csrc/sweep.cu`` ``ray_march_kernel``: the per-pixel march of one
ray (SSGI launches it for each of its two rays, SSR for its one), a
thread a lane. Bytes: 53 a pixel, each read or written once: the view
position and the ray (12 each), the random number (4), the uv (8), the
hit position (12) and the miss flag (1) of the lane, and the frame's
float32 depth texture (4 a texel). Operations: 31 a lane (the step
vector, the start's projection, the results) and the 50 of one step
(the eased step, the projection, the nearest texel, its view z and the
hit test), as ``chip_smoke.py`` counts them (``RM_OPS_LANE``,
``RM_OPS_STEP``): a lane stops at its hit, so every lane takes at least
its first step, while the steps after it and the bisections of a hit
lane depend on the depth and are left out."""

NAME = "ray_march_kernel"


def cost(p):
    px = p["h"] * p["w"]
    return 53 * px, px * (31 + (50 if p["steps"] > 1 else 0))
