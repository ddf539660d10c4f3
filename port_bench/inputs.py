"""The traffic generator: a cell's inputs from ``--seed``.

One general generator for every traffic file. The seed draws only the
free parameters of the motions (an orbit's start angle, a moving
object's phase); every seed gives the same resolution, frame rate,
warm-up and work a frame. The program and the reference receive the
same geometry, matrices, camera poses and sky image from here.
"""

from __future__ import annotations

import numpy as np


class Inputs:
    """The scene (``scenes/<config scene>.py``), and the camera pose and
    object matrices of each frame, drawn from ``seed``."""

    def __init__(self, cell, seed: int):
        traffic = cell.traffic
        self.width, self.height = int(traffic["width"]), int(traffic["height"])
        self.fps = float(traffic["fps"])
        self.warmup = int(traffic["warmup_frames"])
        self.scene = cell.generator("scenes", cell.config["scene"]).generate()
        rng = np.random.default_rng(int(seed) % 2 ** 64)
        cam = traffic["camera"]
        self._camera = (cell.generator("motions", cam["motion"]), cam["params"])
        self._camera_drawn = self._camera[0].draw(cam["params"], rng)
        self._objects = []
        for obj in traffic.get("objects", []):
            gen = cell.generator("motions", obj["motion"])
            self._objects.append((obj["mesh"], gen, obj["params"],
                                  gen.draw(obj["params"], rng)))

    def camera(self, f: int):
        """(position, target) of frame ``f``."""
        gen, params = self._camera
        return gen.pose(params, self._camera_drawn, f)

    def objects(self, f: int) -> dict:
        """{mesh name: world matrix} of the moving meshes at frame ``f``."""
        return {name: gen.pose(params, drawn, f)
                for name, gen, params, drawn in self._objects}
