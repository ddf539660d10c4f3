"""Cameras producing the matrix set every pass consumes.

Host-side numpy analog of three.js' ``PerspectiveCamera`` and
``OrthographicCamera`` with the sub-pixel view-offset jitter that TRAA applies through
``camera.setViewOffset`` (`TAAUtils.js:5-11`). The camera keeps float64;
each frame it is snapshotted into a :class:`CameraMatrices` of float32
host arrays, the values the device arithmetic reads as scalars.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .rng import r2_sequence_point


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float64).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class CameraMatrices:
    """Per-frame camera uniform block (float32 host values)."""

    projection_matrix: np.ndarray          # (4,4) view -> clip
    projection_matrix_inverse: np.ndarray  # (4,4)
    view_matrix: np.ndarray                # (4,4) world -> view
    camera_matrix_world: np.ndarray        # (4,4) view -> world
    position: np.ndarray                   # (3,)
    near: float                            # a float32 value
    far: float

    @property
    def projection_view_matrix(self) -> np.ndarray:
        """P @ V of the float32 matrices, rounded once to float32."""
        return _f32(self.projection_matrix.astype(np.float64)
                    @ self.view_matrix.astype(np.float64))

    @classmethod
    def from_host(cls, world, projection, near, far,
                  view=None) -> "CameraMatrices":
        """Snapshot float64 host matrices; ``view`` defaults to
        ``inv(world)``."""
        proj = np.asarray(projection, np.float64)
        world = np.asarray(world, np.float64)
        return cls(
            projection_matrix=_f32(proj),
            projection_matrix_inverse=_f32(np.linalg.inv(proj)),
            view_matrix=_f32(np.linalg.inv(world) if view is None else view),
            camera_matrix_world=_f32(world),
            position=_f32(world[:3, 3]),
            near=float(np.float32(near)),
            far=float(np.float32(far)),
        )


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Camera-to-world matrix looking from eye to target (-Z forward)."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    z = eye - target
    z /= max(np.linalg.norm(z), 1e-12)
    x = np.cross(up, z)
    n = np.linalg.norm(x)
    if n < 1e-8:  # up parallel to view dir
        x = np.cross(np.array([0.0, 0.0, 1.0]), z)
        n = np.linalg.norm(x)
    x /= n
    y = np.cross(z, x)
    m = np.eye(4)
    m[:3, 0] = x
    m[:3, 1] = y
    m[:3, 2] = z
    m[:3, 3] = eye
    return m


class Camera:
    """Base camera; subclasses fill ``projection_matrix``."""

    def __init__(self, near: float = 0.1, far: float = 1000.0):
        self.near = float(near)
        self.far = float(far)
        self.matrix_world = np.eye(4)
        self.projection_matrix = np.eye(4)
        # setViewOffset state (x, y subpixel offset in pixels)
        self._view_offset: tuple[float, float] | None = None
        self._base_projection = None

    def set_position(self, x, y, z):
        self.matrix_world[:3, 3] = (x, y, z)

    @property
    def position(self) -> np.ndarray:
        return self.matrix_world[:3, 3].copy()

    def look_at(self, target, up=(0.0, 1.0, 0.0)):
        self.matrix_world = look_at(self.matrix_world[:3, 3], target, up)

    @property
    def view_matrix(self) -> np.ndarray:
        return np.linalg.inv(self.matrix_world)

    def set_view_offset(self, full_width: int, full_height: int, x: float,
                        y: float):
        """Sub-pixel projection offset (three.js ``setViewOffset`` with
        width == fullWidth): a shift of (-2x/W, -2y/H) in NDC."""
        if self._base_projection is None:
            self._base_projection = self.projection_matrix.copy()
        m = self._base_projection.copy()
        m[0, :] = m[0, :] - (2.0 * x / full_width) * m[3, :]
        m[1, :] = m[1, :] + (2.0 * y / full_height) * m[3, :]
        self.projection_matrix = m
        self._view_offset = (x, y)

    def clear_view_offset(self):
        if self._base_projection is not None:
            self.projection_matrix = self._base_projection.copy()
            self._base_projection = None
        self._view_offset = None

    def jitter(self, width: int, height: int, frame: int, scale: float = 1.0):
        """R2 low-discrepancy sub-pixel jitter (`TAAUtils.js:5-11`)."""
        jx, jy = r2_sequence_point(frame)
        self.set_view_offset(width, height, (jx - 0.5) * scale,
                             (jy - 0.5) * scale)

    def matrices(self) -> CameraMatrices:
        return CameraMatrices.from_host(self.matrix_world,
                                        self.projection_matrix,
                                        self.near, self.far)


class PerspectiveCamera(Camera):
    is_perspective_camera = True

    def __init__(self, fov: float = 50.0, aspect: float = 1.0,
                 near: float = 0.1, far: float = 1000.0):
        super().__init__(near, far)
        self.fov = float(fov)
        self.aspect = float(aspect)
        self.update_projection_matrix()

    def update_projection_matrix(self):
        top = self.near * math.tan(math.radians(self.fov) * 0.5)
        height = 2.0 * top
        width = self.aspect * height
        left = -0.5 * width
        right = left + width
        bottom = top - height
        n, f = self.near, self.far
        m = np.zeros((4, 4))
        m[0, 0] = 2 * n / (right - left)
        m[0, 2] = (right + left) / (right - left)
        m[1, 1] = 2 * n / (top - bottom)
        m[1, 2] = (top + bottom) / (top - bottom)
        m[2, 2] = -(f + n) / (f - n)
        m[2, 3] = -2 * f * n / (f - n)
        m[3, 2] = -1.0
        self.projection_matrix = m
        self._base_projection = None


class OrthographicCamera(Camera):
    """three.js ``OrthographicCamera``: the frustum box (left, right,
    top, bottom) at [near, far]; clip w is 1 (``P[3, 2] == 0``), which
    ``math3d.depth_to_view_z`` reads to pick the orthographic depth law."""

    is_perspective_camera = False

    def __init__(self, left: float = -1.0, right: float = 1.0,
                 top: float = 1.0, bottom: float = -1.0, near: float = 0.1,
                 far: float = 1000.0):
        super().__init__(near, far)
        self.left, self.right = float(left), float(right)
        self.top, self.bottom = float(top), float(bottom)
        self.update_projection_matrix()

    def update_projection_matrix(self):
        l, r, t, b = self.left, self.right, self.top, self.bottom
        n, f = self.near, self.far
        m = np.eye(4)
        m[0, 0] = 2 / (r - l)
        m[0, 3] = -(r + l) / (r - l)
        m[1, 1] = 2 / (t - b)
        m[1, 3] = -(t + b) / (t - b)
        m[2, 2] = -2 / (f - n)
        m[2, 3] = -(f + n) / (f - n)
        self.projection_matrix = m
        self._base_projection = None


