"""glTF keyframe animation: clips, actions, and the mixer.

The reference's example app plays glTF animations through three.js'
``AnimationMixer`` (`example/main.js:949-955`: it builds
a mixer over the loaded asset, starts a ``clipAction`` per clip, and
advances it with the measured frame dt at `main.js:629-632`). The
library's own machinery then sees the animation only through its
consequences — per-mesh model matrices, bone palettes, and morph weights
changing frame to frame, which the velocity pass turns into motion
vectors (`VelocityDepthNormalPass.js:24-64`).

This module reproduces that contract natively: :class:`AnimationMixer`
samples keyframe channels (translation/rotation/scale/weights with
LINEAR / STEP / CUBICSPLINE interpolation per the glTF 2.0 spec),
recomputes the node hierarchy's global transforms, and pushes the
results into the framework's :class:`~.geometry.Mesh` per-frame API
(``set_matrix`` / ``set_bones`` / ``set_morph_weights``), which already
maintains the previous-frame snapshots the velocity rasterizer consumes.
Numpy only: a copy of the JAX package's ``scene/animation.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


# ---------------------------------------------------------------------------
# Quaternion / TRS helpers (host math, float64)
# ---------------------------------------------------------------------------

def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """(x, y, z, w) unit quaternion -> 3x3 rotation matrix."""
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def matrix_to_quat(m: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix -> (x, y, z, w) unit quaternion (Shepperd)."""
    t = np.trace(m)
    if t > 0:
        s = 0.5 / np.sqrt(t + 1.0)
        return np.array([(m[2, 1] - m[1, 2]) * s, (m[0, 2] - m[2, 0]) * s,
                         (m[1, 0] - m[0, 1]) * s, 0.25 / s])
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = 2.0 * np.sqrt(max(1.0 + m[i, i] - m[j, j] - m[k, k], 1e-12))
    q = np.empty(4)
    q[i] = 0.25 * s
    q[j] = (m[j, i] + m[i, j]) / s
    q[k] = (m[k, i] + m[i, k]) / s
    q[3] = (m[k, j] - m[j, k]) / s
    return q / np.linalg.norm(q)


def slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    """Spherical interpolation with the shortest-path sign flip."""
    d = float(np.dot(q0, q1))
    if d < 0.0:
        q1, d = -q1, -d
    if d > 0.9995:  # nearly parallel: lerp + renormalize
        out = q0 + t * (q1 - q0)
        return out / np.linalg.norm(out)
    theta = np.arccos(np.clip(d, -1.0, 1.0))
    s = np.sin(theta)
    return (np.sin((1.0 - t) * theta) * q0 + np.sin(t * theta) * q1) / s


def compose_trs(t: np.ndarray, r: np.ndarray, s: np.ndarray) -> np.ndarray:
    """TRS -> 4x4 (glTF node order: M = T * R * S)."""
    m = np.eye(4)
    m[:3, :3] = quat_to_matrix(r) @ np.diag(s)
    m[:3, 3] = t
    return m


def decompose_trs(m: np.ndarray):
    """4x4 -> (translation, quaternion, scale); mirrors three.js
    ``Matrix4.decompose`` (negative determinant flips sx)."""
    m = np.asarray(m, np.float64)
    t = m[:3, 3].copy()
    sx = np.linalg.norm(m[:3, 0])
    sy = np.linalg.norm(m[:3, 1])
    sz = np.linalg.norm(m[:3, 2])
    if np.linalg.det(m[:3, :3]) < 0:
        sx = -sx
    rot = np.column_stack([
        m[:3, 0] / (sx if sx != 0 else 1.0),
        m[:3, 1] / (sy if sy != 0 else 1.0),
        m[:3, 2] / (sz if sz != 0 else 1.0),
    ])
    return t, matrix_to_quat(rot), np.array([sx, sy, sz])


# ---------------------------------------------------------------------------
# Clip data model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AnimationChannel:
    """One sampler+target pair: keyframe track for a node property."""

    node: int                 #: target node index in the asset's node table
    path: str                 #: "translation" | "rotation" | "scale" | "weights"
    times: np.ndarray         #: (N,) keyframe times, seconds, ascending
    values: np.ndarray        #: (N, C) — or (N, 3, C) for CUBICSPLINE
    interpolation: str = "LINEAR"   #: LINEAR | STEP | CUBICSPLINE

    def sample(self, t: float) -> np.ndarray:
        """Evaluate the track at time ``t`` (clamped to the key range)."""
        times = self.times
        if t <= times[0]:
            v = self.values[0]
            return v[1] if self.interpolation == "CUBICSPLINE" else v
        if t >= times[-1]:
            v = self.values[-1]
            return v[1] if self.interpolation == "CUBICSPLINE" else v
        i = int(np.searchsorted(times, t, side="right")) - 1
        t0, t1 = float(times[i]), float(times[i + 1])
        u = (t - t0) / max(t1 - t0, 1e-12)
        if self.interpolation == "STEP":
            return self.values[i]
        if self.interpolation == "CUBICSPLINE":
            # glTF 2.0 spec, appendix C: cubic Hermite with in/out tangents
            # scaled by the keyframe interval
            dt = t1 - t0
            p0, m0 = self.values[i][1], self.values[i][2] * dt
            p1, m1 = self.values[i + 1][1], self.values[i + 1][0] * dt
            u2, u3 = u * u, u * u * u
            out = ((2 * u3 - 3 * u2 + 1) * p0 + (u3 - 2 * u2 + u) * m0
                   + (-2 * u3 + 3 * u2) * p1 + (u3 - u2) * m1)
            if self.path == "rotation":
                out = out / np.linalg.norm(out)
            return out
        if self.path == "rotation":
            return slerp(self.values[i], self.values[i + 1], u)
        return (1.0 - u) * self.values[i] + u * self.values[i + 1]


@dataclasses.dataclass
class AnimationClip:
    """Named group of channels (three.js ``AnimationClip`` analog)."""

    name: str
    channels: list
    duration: float = 0.0

    def __post_init__(self):
        if not self.duration:
            self.duration = max(
                (float(c.times[-1]) for c in self.channels), default=0.0)


class AnimationAction:
    """Playback state of one clip (three.js ``AnimationAction`` analog,
    `main.js:955-957`: actions are created per clip and ``.play()``ed)."""

    def __init__(self, clip: AnimationClip):
        self.clip = clip
        self.time = 0.0
        self.time_scale = 1.0
        self.enabled = False
        self.loop = True  #: three.js LoopRepeat default

    def play(self):
        self.enabled = True
        return self

    def stop(self):
        self.enabled = False
        self.time = 0.0
        return self

    def clip_time(self) -> float:
        """Current local clip time after loop wrapping (an exact multiple
        of the duration maps to the end pose, not the restart)."""
        d = self.clip.duration
        if d <= 0.0:
            return 0.0
        if not self.loop:
            return min(self.time, d)
        t = self.time % d
        return d if (t == 0.0 and self.time > 0.0) else t


class AnimationMixer:
    """Advances actions and writes sampled values into the asset's node
    hierarchy, then propagates to meshes / bone palettes / morph weights.

    ``mixer = AnimationMixer(asset); mixer.clip_action(clip).play();
    mixer.update(dt)`` mirrors the reference's usage at
    `example/main.js:949-957,629-632`.
    """

    def __init__(self, asset):
        self.asset = asset
        self._actions: dict[int, AnimationAction] = {}

    def clip_action(self, clip) -> AnimationAction:
        """Get/create the action for a clip (by object, index, or name)."""
        clips = self.asset.animations
        if isinstance(clip, int):
            clip = clips[clip]
        elif isinstance(clip, str):
            clip = next(c for c in clips if c.name == clip)
        key = id(clip)
        if key not in self._actions:
            self._actions[key] = AnimationAction(clip)
        return self._actions[key]

    def update(self, dt: float):
        """Advance all playing actions by ``dt`` seconds and apply."""
        for action in self._actions.values():
            if action.enabled:
                action.time += dt * action.time_scale
        self.apply()

    def set_time(self, t: float):
        """Seek all playing actions to absolute time ``t`` and apply."""
        for action in self._actions.values():
            if action.enabled:
                action.time = t
        self.apply()

    def apply(self):
        """Sample every playing action into node TRS / weights, then
        push recomputed globals into the meshes. Multiple actions
        touching the same channel apply in creation order (last wins)."""
        asset = self.asset
        touched = False
        for action in self._actions.values():
            if not action.enabled or not action.clip.channels:
                continue
            t = action.clip_time()
            for ch in action.clip.channels:
                v = np.asarray(ch.sample(t), np.float64)
                if ch.path == "translation":
                    asset.node_translation[ch.node] = v
                elif ch.path == "rotation":
                    asset.node_rotation[ch.node] = v / np.linalg.norm(v)
                elif ch.path == "scale":
                    asset.node_scale[ch.node] = v
                elif ch.path == "weights":
                    asset.node_weights[ch.node] = v.astype(np.float32)
                touched = True
        if touched:
            asset.apply_node_transforms()
