"""The camera orbit of the port's ``bench.py`` (``_orbit``,
``bench.py:359-362`` of the JAX repository): radius ``radius`` at height
``height`` around ``target``, ``rad_per_frame`` a frame, from a start
angle drawn from the seed."""

from __future__ import annotations

import math


def draw(params: dict, rng) -> dict:
    return {"start": float(rng.uniform(0.0, 2.0 * math.pi))}


def pose(params: dict, drawn: dict, f: int):
    ang = drawn["start"] + params["rad_per_frame"] * f
    r = params["radius"]
    return (r * math.sin(ang), params["height"], r * math.cos(ang)), tuple(params["target"])
