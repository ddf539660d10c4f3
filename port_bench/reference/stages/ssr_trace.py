"""The SSR trace in sweep mode, per pixel: upstream's `SSREffect.js:3-9`
(the SSGI pass with its mode set to SSR) and `ssgi.frag`'s specular
branch. Every pixel draws the GGX-VNDF specular ray or, chosen against
roughness, the environment's importance sample, and takes the specular
BRDF and pdf alone (no diffuse sample is drawn); the ray is swept as in
``ssgi_trace.py`` (16 direction bins, 32 geometric radii, the closed-form
refine, the prewarped radiance at the hit texel), faded into the
environment at the border, the environment taken on a miss, weighted by
MIS, and the direct light added. The diffuse output is -1 with the
roughness as its fourth channel; the specular output carries the ray's
world length. The environment's prepared tables (``ctx.env``) are taken
as given inputs.
"""

from __future__ import annotations

from .ssgi_trace import trace


def step(rec):
    return trace(rec, ssr=True)
