"""EffectComposer: the frame driver of the effect chain.

Per frame, on the host: camera jitter bookkeeping (`TAAUtils.js:5-11`),
previous-matrix snapshots (`TemporalReprojectPass.js:202-213`),
camera-moved detection (`SceneUtils.js:17-43`) and the one-frame
``keepData=0`` reset (`TemporalReprojectPass.js:158-160`). On the device:
each effect in turn over (H, W, C) tensors, with the temporal state in
an explicit dict that the frame replaces.

The per-frame values stay host floats (matrices as float32 numpy
arrays), so a frame copies nothing from the host to the card.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .core.camera import Camera, CameraMatrices
from .core.envmap import EquirectEnv, build_equirect_env
from .core.framebuffers import GBuffer, VelocityBuffer


@dataclasses.dataclass(frozen=True)
class FrameContext:
    """Everything an effect stage may read."""

    gbuffer: GBuffer
    velocity: VelocityBuffer
    last_velocity: VelocityBuffer
    scene_color: torch.Tensor         # direct-lit input (H, W, 3)
    cam: CameraMatrices               # jittered (matches the G-buffer)
    unjittered_cam: CameraMatrices
    prev_cam: CameraMatrices          # previous frame, unjittered
    frame_index: int
    params: dict                      # per-effect uniform dicts
    env: object = None                # EquirectEnv | None


def _rigid_inverse(m: np.ndarray) -> np.ndarray:
    """Inverse of a rigid transform (R | t): (R^T | -R^T t)."""
    out = np.eye(4)
    rt = m[:3, :3].T
    out[:3, :3] = rt
    out[:3, 3] = -rt @ m[:3, 3]
    return out


def _camera(camera: Camera, world, projection) -> CameraMatrices:
    return CameraMatrices.from_host(world, projection, camera.near,
                                    camera.far, view=_rigid_inverse(world))


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device; raises when
    CUDA is absent and the CPU was not asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run the plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class EffectComposer:
    """Drives the frame loop; owns effects, state and host bookkeeping.

    :meth:`render_external` reads only ``scene.environment`` (any object
    with that attribute, until ``Scene`` is ported with the raster
    slice); ``scene`` may be None for effects that need no environment."""

    def __init__(self, scene, camera: Camera, width: int, height: int,
                 device=None):
        self.device = resolve_device(device)
        self.scene = scene
        self.camera = camera
        self.width = int(width)
        self.height = int(height)
        self.effects = []
        self.frame = 0
        self.camera_not_moved_frames = 0
        self._state = None
        self._prev_world = None
        self._prev_proj = None
        self._last_world = None
        self._reset_pending = True
        self._env_key = None        # id() of the raw map last built
        self._env_built = None      # the EquirectEnv built from it
        self._env_raw = None        # the raw map (pins its id)
        #: per-frame dt (`MotionBlurEffect.js:87-89`): wall clock between
        #: renders, clamped to >= 1 ms, overridable with ``dt=``
        self.delta_time = 1.0 / 60.0
        self._last_frame_walltime = None
        #: set True to fill :attr:`last_timings` (ms per effect stage,
        #: CUDA events on the card, the host clock on the CPU); adds one
        #: synchronisation per frame
        self.collect_timings = False
        self.last_timings: dict[str, float] = {}

    # ------------------------------------------------------------------
    def add_effect(self, effect) -> "EffectComposer":
        if any(e.name == effect.name for e in self.effects):
            raise ValueError(f"effect name {effect.name!r} already in the "
                             "composer; give the instance a unique .name")
        self.effects.append(effect)
        self._state = None
        return self

    def reset(self):
        """Discard temporal history next frame (keepData=0 for one frame)."""
        self._reset_pending = True

    def refresh_environment(self):
        """Rebuild the environment next frame. A new raw map assigned to
        ``scene.environment`` is detected by identity (the reference's
        texture-uuid check, `SSGIEffect.js:317-329`); call this after
        changing the same array in place."""
        self._env_key = None

    def _resolve_environment(self):
        """The frame's :class:`EquirectEnv` or None (`SSGIEffect.js:309-366`).
        ``scene.environment`` may be a prebuilt ``EquirectEnv`` (used as it
        is) or a raw (H, W, 3) equirect map, built on this composer's
        device when its identity changes; a rebuild resets the temporal
        history."""
        env = getattr(self.scene, "environment", None)
        if env is None:
            self._env_key = self._env_built = self._env_raw = None
            return None
        if isinstance(env, EquirectEnv):
            if env.device != self.device:
                raise ValueError(f"environment on {env.device}, composer "
                                 f"on {self.device}")
            return env
        if self._env_key != id(env) or self._env_built is None:
            arr = np.asarray(env, np.float32)
            if arr.ndim != 3 or arr.shape[-1] != 3:
                raise NotImplementedError(
                    f"an environment of shape {arr.shape}: only (H, W, 3) "
                    "equirect maps are ported; cube maps wait for "
                    "cube_to_equirect (ROADMAP item 10.6)")
            self._env_built = build_equirect_env(arr, device=self.device)
            self._env_key = id(env)
            self._env_raw = env
            self.reset()
        return self._env_built

    def set_size(self, width: int, height: int):
        """Resize the frame; discards temporal state like the reference's
        render-target reallocation."""
        if (width, height) == (self.width, self.height):
            return
        self.width = int(width)
        self.height = int(height)
        self._state = None
        self._reset_pending = True

    def _init_state(self) -> dict:
        state = {"__global__": {"last_velocity": VelocityBuffer.zeros(
            self.height, self.width, self.device)}}
        for e in self.effects:
            state[e.name] = e.init_state(self.height, self.width, self.device)
        return state

    # ------------------------------------------------------------------
    def render(self, dt: float | None = None):
        raise NotImplementedError(
            "render() needs the rasterizer, which is not ported yet (the "
            "raster slice); drive the effects with render_external()")

    def render_external(self, gbuffer: GBuffer, velocity: VelocityBuffer,
                        scene_color: torch.Tensor, dt: float | None = None):
        """Run the effect chain on caller-supplied buffers on this
        composer's device: a G-buffer, the velocity buffer and the lit
        scene colour (H, W, 3). Returns the (H, W, 3) image. External
        buffers are never jittered."""
        for t in (gbuffer.depth, velocity.depth, scene_color):
            if t.device != self.device:
                raise ValueError(f"buffers on {t.device}, composer on "
                                 f"{self.device}")
        if tuple(gbuffer.depth.shape) != (self.height, self.width):
            raise ValueError(f"buffers of {tuple(gbuffer.depth.shape)}, "
                             f"composer of {(self.height, self.width)}")
        if self._state is None:
            self._state = self._init_state()

        now = time.perf_counter()
        if dt is None:
            dt = (now - self._last_frame_walltime
                  if self._last_frame_walltime is not None else 1.0 / 60.0)
        self._last_frame_walltime = now
        self.delta_time = max(1.0 / 1000.0, float(dt))

        # host-side camera bookkeeping
        self.camera.clear_view_offset()
        world = np.asarray(self.camera.matrix_world, np.float64).copy()
        proj = np.asarray(self.camera.projection_matrix, np.float64).copy()
        moved = (self._last_world is None
                 or np.abs(self._last_world - world).max() > 1e-6)
        self.camera_not_moved_frames = (0 if moved
                                        else self.camera_not_moved_frames + 1)
        env = self._resolve_environment()
        prev_world = self._prev_world if self._prev_world is not None else world
        prev_proj = self._prev_proj if self._prev_proj is not None else proj
        for e in self.effects:
            e.host_update(self)

        unjit = _camera(self.camera, world, proj)
        params = {"__global__": {
            "keep_data": 0.0 if self._reset_pending else 1.0,
            "camera_moved": bool(moved),
            "camera_not_moved_frames": self.camera_not_moved_frames,
        }}
        for e in self.effects:
            params[e.name] = {k: float(v) for k, v in e.uniforms().items()}
        ctx = FrameContext(
            gbuffer=gbuffer, velocity=velocity,
            last_velocity=self._state["__global__"]["last_velocity"],
            scene_color=scene_color,
            cam=unjit,  # external buffers are never jittered
            unjittered_cam=unjit,
            prev_cam=_camera(self.camera, prev_world, prev_proj),
            frame_index=self.frame % 4096,
            params=params,
            env=env,
        )

        timer = _StageTimer(self.device) if self.collect_timings else None
        new_state = {"__global__": {"last_velocity": velocity}}
        image = scene_color
        for e in self.effects:
            if timer:
                timer.start(e.name)
            image, new_state[e.name] = e.apply(ctx, image, self._state[e.name])
            if timer:
                timer.stop()
        if timer:
            self.last_timings = timer.read()
        self._state = new_state

        self._prev_world = world
        self._prev_proj = proj
        self._last_world = world
        self.frame += 1
        self._reset_pending = False
        return image

    # ------------------------------------------------------------------
    def state(self, effect_name: str):
        """An effect's state dict (observability hook)."""
        return self._state[effect_name] if self._state else None

    def save_state(self, path: str):
        """Write the temporal state and frame counters to ``path`` (.npz).
        Resume with :meth:`load_state` on a composer with the same effect
        stack and size."""
        from .convert import flatten_state, state_to_numpy

        if self._state is None:
            raise RuntimeError("no state yet: render at least one frame")
        arrays = flatten_state(state_to_numpy(self._state))
        arrays["__frame__"] = np.asarray(self.frame)
        arrays["__cnmf__"] = np.asarray(self.camera_not_moved_frames)
        arrays["__prev_world__"] = np.asarray(
            self._prev_world if self._prev_world is not None else np.eye(4))
        arrays["__prev_proj__"] = np.asarray(
            self._prev_proj if self._prev_proj is not None else np.eye(4))
        np.savez(path, **arrays)

    def load_state(self, path: str):
        """Restore what :meth:`save_state` wrote."""
        from .convert import state_from_numpy, unflatten_state

        with np.load(path) as data:
            arrays = {k: data[k] for k in data.files}
        frame = int(arrays.pop("__frame__"))
        cnmf = int(arrays.pop("__cnmf__"))
        prev_world = arrays.pop("__prev_world__")
        prev_proj = arrays.pop("__prev_proj__")
        self.set_state(state_from_numpy(unflatten_state(arrays), self.device),
                       frame, cnmf, prev_world, prev_proj)

    def set_state(self, state: dict, frame: int,
                  camera_not_moved_frames: int, prev_world, prev_proj):
        """Resume from a temporal state (e.g. one carried over from the
        JAX package by ``convert.state_from_numpy``) and the frame
        counters and camera of the frame that produced it."""
        expected = {"__global__"} | {e.name for e in self.effects}
        if set(state) != expected:
            raise ValueError(f"state keys {sorted(state)} != {sorted(expected)}")
        self._state = state
        self.frame = int(frame)
        self.camera_not_moved_frames = int(camera_not_moved_frames)
        self._prev_world = np.asarray(prev_world, np.float64)
        self._prev_proj = np.asarray(prev_proj, np.float64)
        self._last_world = self._prev_world
        self._reset_pending = False


class _StageTimer:
    """Milliseconds per named stage: CUDA events on the card, the host
    clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def start(self, name: str):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        else:
            ev = time.perf_counter()
        self.marks.append([name, ev, None])

    def stop(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        else:
            ev = time.perf_counter()
        self.marks[-1][2] = ev

    def read(self) -> dict[str, float]:
        if self.cuda:
            torch.cuda.synchronize()
            return {n: a.elapsed_time(b) for n, a, b in self.marks}
        return {n: (b - a) * 1e3 for n, a, b in self.marks}
