"""A composer built from a cell's configuration and inputs, with either
package: the program (``realism_effects_tpu_torch``) or the plain
reference (``port_bench.reference.port``). Both expose the same public
names, so one builder serves both sides."""

from __future__ import annotations

import numpy as np


class Rig:
    """``pkg``'s ``EffectComposer`` over the cell's scene and stack on
    ``device``; :meth:`render` renders frame ``f`` of the inputs."""

    def __init__(self, pkg, cell, inputs, device):
        self.inputs = inputs
        scene = pkg.Scene()
        data = inputs.scene
        for key, value in data["lighting"].items():
            setattr(scene, key, value if key == "sun_intensity"
                    else np.asarray(value, np.float32))
        self.meshes = {}
        for m in data["meshes"]:
            mesh = pkg.Mesh(m["positions"].copy(), m["normals"].copy(),
                            m["faces"].copy(), pkg.Material(**m["material"]),
                            uvs=m["uvs"].copy())
            mesh.set_matrix(m["matrix"])
            scene.add(mesh)
            self.meshes[m["name"]] = mesh
        scene.environment = pkg.build_equirect_env(data["sky"], device=device)
        cam_cfg = cell.config["camera"]
        self.camera = pkg.PerspectiveCamera(cam_cfg["fov"],
                                            inputs.width / inputs.height,
                                            cam_cfg["near"], cam_cfg["far"])
        self.comp = pkg.EffectComposer(scene, self.camera, inputs.width,
                                       inputs.height, device=device)
        for e in cell.config["stack"]:
            self.comp.add_effect(getattr(pkg, e["effect"])(**e.get("options", {})))
        self.state_names = ["__global__"] + [e.name for e in self.comp.effects]

    def pose(self, f: int):
        """Set the camera and the moving meshes to frame ``f``."""
        pos, target = self.inputs.camera(f)
        self.camera.set_position(*pos)
        self.camera.look_at(target)
        for name, m in self.inputs.objects(f).items():
            self.meshes[name].set_matrix(m)

    def render(self, f: int):
        self.pose(f)
        return self.comp.render(dt=1.0 / self.inputs.fps)

    def state(self) -> dict:
        """The composer's temporal state, by stage name (references to its
        tensors, no copies)."""
        return {name: self.comp.state(name) for name in self.state_names}
