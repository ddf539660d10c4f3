"""Config 5's box motion (the port's ``bench.py`` ``build_config(5)``,
``bench.py:272-346`` of the JAX repository): at time t = f / fps + t0
the mesh translates by ``sin(rate t) * amplitude`` along x from ``base``
and turns ``spin t`` about y; the phase t0 is drawn from the seed."""

from __future__ import annotations

import math

import numpy as np


def draw(params: dict, rng) -> dict:
    return {"t0": float(rng.uniform(0.0, 2.0 * math.pi / params["rate"]))}


def pose(params: dict, drawn: dict, f: int) -> np.ndarray:
    t = f / params["fps"] + drawn["t0"]
    x, y, z = params["base"]
    m = np.eye(4)
    m[:3, 3] = (x + math.sin(t * params["rate"]) * params["amplitude"], y, z)
    c, s = math.cos(t * params["spin"]), math.sin(t * params["spin"])
    r = np.eye(4)
    r[0, 0], r[0, 2], r[2, 0], r[2, 2] = c, s, -s, c
    return m @ r
