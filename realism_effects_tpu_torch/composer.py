"""EffectComposer: the frame driver.

Per frame, on the host: camera jitter bookkeeping (`TAAUtils.js:5-11`),
previous-matrix snapshots (`TemporalReprojectPass.js:202-213`),
camera-moved detection (`SceneUtils.js:17-43`) and the one-frame
``keepData=0`` reset (`TemporalReprojectPass.js:158-160`). On the device:
:meth:`EffectComposer.render` rasterizes the scene (G-buffer with the
jittered camera, velocity with the unjittered current and previous
cameras), shades it, then runs each effect in turn over (H, W, C)
tensors, with the temporal state in an explicit dict that the frame
replaces; :meth:`EffectComposer.render_external` runs the effects on
buffers the caller supplies. Both go through one frame body, which is
also the JAX package's monolithic frame function
(:meth:`EffectComposer._build_frame_fn`).

The split frame: ``_build_frame_fn(mesh)`` (and ``render(mesh=...)``)
runs the same body with the frame's images and its temporal state held
as row blocks over a mesh of devices, each stage per shard or whole as
``parallel/__init__.py`` sets out; its values are the unsplit frame's.

The packed scene and the lighting go to the device once. The camera
matrices and the effects' uniforms stay host floats that enter the
device arithmetic as scalars; the per-mesh model matrices, bone palettes
and morph weights (a few KB) are copied to the device each frame.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from . import tracing
from .core.camera import Camera, CameraMatrices
from .core.envmap import EquirectEnv, build_equirect_env, cube_to_equirect
from .core.framebuffers import GBuffer, VelocityBuffer
from .core.rng import blue_noise_transform
from .parallel.halo import SplitFrame
from .parallel.sharding import gather_pytree
from .scene.rasterizer import rasterize_gbuffer, rasterize_velocity
from .scene.shading import shade_direct


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
    #: restricted G-buffer (excluded faces absent) for exact SSGI
    #: Selection (`SSGIPass.js:71-79`); None unless an effect asks for
    #: ``selection="rerender"`` and the scene excludes a mesh
    gi_gbuffer: GBuffer | None = None


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


def _map_planes(buf, fn):
    """``buf`` (a G-buffer or velocity buffer) with ``fn`` applied to each
    of its tensors."""
    return dataclasses.replace(buf, **{
        f.name: fn(getattr(buf, f.name)) for f in dataclasses.fields(buf)
        if isinstance(getattr(buf, f.name), torch.Tensor)})


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

    ``scene`` is a :class:`Scene` for :meth:`render`. :meth:`render_external`
    reads only ``scene.environment`` (and ``scene.gi_mask()`` where the
    scene has one), so there ``scene`` may be any object with an
    ``environment`` attribute, or None for effects that need no
    environment."""

    def __init__(self, scene, camera: Camera, width: int, height: int,
                 device=None, alpha_peels: int = 3, msaa: int = 1):
        self.device = resolve_device(device)
        self.scene = scene
        self.camera = camera
        self.width = int(width)
        self.height = int(height)
        #: geometric-edge anti-aliasing by supersampled raster: ``msaa=s``
        #: rasterizes and shades at s*s the display resolution and
        #: box-resolves the colour (the reference demo's ``multisampling``
        #: composer branch, `example/main.js:116-154`, as true SSAA); the
        #: G-buffer and velocity planes the effects read resolve by
        #: picking each block's centre sample
        self.msaa = max(1, int(msaa))
        #: depth-peel passes bounding alpha-map transparency depth
        #: (scene/rasterizer._visibility); each peel is one more plane of
        #: the G-buffer's and the velocity raster's alpha z-scan
        self.alpha_peels = int(alpha_peels)
        #: resolve visibility once per frame: the velocity pass reuses the
        #: G-buffer scan's winner ids (off by default: under TRAA the
        #: G-buffer scan is jittered, see the JAX package's composer)
        self.share_visibility = False
        self.effects = []
        self.frame = 0
        self.camera_not_moved_frames = 0
        self._state = None
        self._packed = None         # PackedScene on the device
        self._lighting = None       # lighting params on the device
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
        #: set True to time each stage span (``tracing.stage``: CUDA
        #: events on the card, the host clock on the CPU), read by
        #: :attr:`last_timings`
        self.collect_timings = False
        self._timed_stages = []
        #: where the last frame ran each stage: "shard" or "whole" by
        #: stage name (``raster``, ``shade``, then the effects' names);
        #: empty after a frame with no mesh
        self.last_placement: dict[str, str] = {}

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

    def refresh_lighting(self):
        """Re-stage the scene's lighting on the device next frame (it is
        staged once, at the first render); changing which parameters
        exist (``sun_specular``, point lights) is picked up too."""
        self._lighting = None

    def refresh_environment(self):
        """Rebuild the environment next frame. A new raw map assigned to
        ``scene.environment`` is detected by identity (the reference's
        texture-uuid check, `SSGIEffect.js:317-329`); call this after
        changing the same array in place."""
        self._env_key = None

    def _resolve_environment(self):
        """The frame's :class:`EquirectEnv` or None (`SSGIEffect.js:309-366`).
        ``scene.environment`` may be a prebuilt ``EquirectEnv`` (used as it
        is), a raw (H, W, 3) equirect map or (6, S, S, 3) cube faces (an
        array or a tensor). Cube faces become a (2S, 4S, 3) equirect by
        ``cube_to_equirect`` on this composer's device
        (`CubeToEquirectEnvPass.js:59-99`); the map is built on this
        composer's device, its CDF tables on the host, when its identity
        changes, and a rebuild resets the temporal history."""
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
            arr = env if isinstance(env, torch.Tensor) else np.asarray(env, np.float32)
            if arr.ndim == 4 and arr.shape[0] == 6 and arr.shape[-1] == 3:
                s = arr.shape[1]
                arr = cube_to_equirect(
                    torch.as_tensor(arr, dtype=torch.float32, device=self.device),
                    2 * s, 4 * s)
            if arr.ndim != 3 or arr.shape[-1] != 3:
                raise ValueError(
                    f"an environment of shape {tuple(arr.shape)}: expected an "
                    "(H, W, 3) equirect map or (6, S, S, 3) cube faces")
            if isinstance(arr, torch.Tensor):  # the CDF tables build on the host
                arr = arr.detach().to("cpu", torch.float32).numpy()
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
    def render(self, dt: float | None = None, mesh=None):
        """Rasterize, shade and run the effect chain on the composer's
        :class:`Scene`; returns the (H, W, 3) image on the device.

        ``dt``: seconds since the previous frame, for frame-rate-dependent
        effects (motion blur); defaults to the wall clock between calls,
        clamped to >= 1 ms (`MotionBlurEffect.js:87-89`).

        ``mesh`` (``parallel.sharding.make_mesh``): run the split frame
        (``_build_frame_fn(mesh)``); the image comes back as
        ``RowBlocks``, and the temporal state is kept as row blocks
        (:meth:`state` and :meth:`save_state` join them)."""
        if not hasattr(self.scene, "meshes"):
            raise ValueError("render() rasterizes the composer's Scene; "
                             "without one, drive the effects with "
                             "render_external()")
        return self._render_frame(None, dt, mesh)

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
        return self._render_frame((gbuffer, velocity, scene_color), dt)

    @property
    def last_timings(self) -> dict[str, float]:
        """ms per stage of the last frame rendered with
        :attr:`collect_timings` on (``raster`` for render(), then one per
        effect); reading it synchronises once. Empty after a frame with
        it off."""
        return tracing.stage_ms(self._timed_stages)

    def _stage_scene(self):
        """(packed scene, lighting) on the device, staged once."""
        if self._packed is None:
            self._packed = self.scene.pack(self.device)
        if self._lighting is None:
            self._lighting = self.scene.lighting_params(self.device)
        return self._packed, self._lighting

    def _raster(self, packed, model_mats, prev_model_mats, cam, unjit, prev,
                env, lighting, frame_index, params, shade: bool = True):
        """The frame's (G-buffer, velocity, lit colour, restricted
        G-buffer or None) from the scene, rasterized and shaded at
        ``msaa`` times the frame's size and resolved to it. The skinning
        and morph inputs come from the scene; without ``shade`` (and
        ``msaa`` 1) the colour is None."""
        scene, dev = self.scene, self.device
        ss = self.msaa
        h, w = self.height * ss, self.width * ss
        t = lambda a, site: tracing.to_device(a, dev, torch.float32, site)
        with tracing.span("pass:raster.upload"):
            mm = t(model_mats, "composer.model_matrices")
            pmm = t(prev_model_mats, "composer.prev_model_matrices")
            bones = prev_bones = morph = prev_morph = None
            if scene.num_bones() > 1:
                bones = t(scene.bone_matrices(), "composer.bones")
                prev_bones = t(scene.bone_matrices(prev=True), "composer.prev_bones")
            if scene.max_morph_targets() > 0:
                morph = t(scene.morph_weight_matrix(), "composer.morph_weights")
                prev_morph = t(scene.morph_weight_matrix(prev=True),
                               "composer.prev_morph_weights")
        with tracing.span("pass:raster.gbuffer"):
            dither = None
            cnmf = params["camera_not_moved_frames"]
            if any(m.material.diffuse[3] < 1.0 or m.material.alpha_map is not None
                   for m in scene.meshes):
                # the dither, animated by the still-frame counter so TRAA/TAA
                # converge transparency (`GBufferPass.js:59,78-82`): the blue
                # noise's first channel, taken on the tile before it is tiled
                # out, so the z-scan reads a plane with unit x stride
                dither = blue_noise_transform(h, w, int(cnmf) + frame_index,
                                              lambda t: t[..., :1], device=dev)[..., 0]
            alpha = dict(dither=dither, cnmf=float(cnmf), alpha_peels=self.alpha_peels)
            gbuffer = rasterize_gbuffer(packed, mm, cam.projection_view_matrix, h, w,
                                        bones=bones, morph_weights=morph,
                                        return_ids=self.share_visibility, **alpha)
            ids = None
            if self.share_visibility:
                gbuffer, ids = gbuffer
        with tracing.span("pass:raster.velocity"):
            velocity = rasterize_velocity(
                packed, mm, pmm, unjit.projection_view_matrix,
                prev.projection_view_matrix, h, w, bones=bones,
                prev_bones=prev_bones, morph_weights=morph,
                prev_morph_weights=prev_morph, share_ids=ids, **alpha)
        color = None
        if shade or ss > 1:
            with tracing.span("pass:raster.shade"):
                color = shade_direct(gbuffer, cam, lighting, env)
        gi_gbuffer = None
        gi_w = params.get("gi_mask_meshes")
        excluded = (np.zeros(0, bool) if gi_w is None
                    else np.asarray(gi_w) < 0.5)
        if excluded.any() and any(getattr(e, "selection", "mask") == "rerender"
                                  for e in self.effects):
            # exact Selection: a second raster pass without the excluded
            # meshes' faces (`SSGIPass.js:71-79`)
            with tracing.span("pass:raster.gbuffer"):
                face_keep = ~tracing.to_device(excluded, dev, site="composer.face_keep")[
                    packed.face_mesh]
                gi_gbuffer = rasterize_gbuffer(
                    packed, mm, cam.projection_view_matrix, h, w, bones=bones,
                    morph_weights=morph, face_keep=face_keep, **alpha)
        if ss > 1:
            # the resolve: the box average of each ss x ss block of the
            # shaded colour; the centre sample of the planes the effects
            # read (depth, normals and ids do not average)
            with tracing.span("pass:raster.shade"):
                color = color.reshape(self.height, ss, self.width, ss, 3).mean((1, 3))
                pick = lambda buf: _map_planes(
                    buf, lambda a: a[ss // 2::ss, ss // 2::ss].contiguous())
                gbuffer, velocity = pick(gbuffer), pick(velocity)
                if gi_gbuffer is not None:
                    gi_gbuffer = pick(gi_gbuffer)
        return gbuffer, velocity, color, gi_gbuffer

    def build_params(self, moved: bool = False) -> dict:
        """The frame's uniform dict, as the frame function reads it (the
        JAX package's ``build_params``): the global flags from the
        composer's counters, each effect's :meth:`uniforms` as host
        floats."""
        gi_mask = getattr(self.scene, "gi_mask", None)
        params = {"__global__": {
            "keep_data": 0.0 if self._reset_pending else 1.0,
            "camera_moved": bool(moved),
            "camera_not_moved_frames": self.camera_not_moved_frames,
            # per-mesh SSGI participation, a host array
            "gi_mask_meshes": gi_mask() if gi_mask is not None else None,
        }}
        for e in self.effects:
            params[e.name] = {k: float(v) for k, v in e.uniforms().items()}
        return params

    def _model_matrices(self):
        """(model matrices, previous ones) of the scene, host arrays; an
        empty scene rasterizes nothing under one identity."""
        if self.scene.meshes:
            return self.scene.model_matrices(), self.scene.prev_model_matrices()
        return np.eye(4)[None], np.eye(4)[None]

    def _render_frame(self, external, dt, mesh=None):
        """The host side of :meth:`render` (``external`` None) and
        :meth:`render_external` (``external`` = the buffers) around the
        frame body, inside the frame's ``frame`` span."""
        with tracing.frame(self.frame):
            return self._render_body(external, dt, mesh)

    def _render_body(self, external, dt, mesh):
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
        jit_proj = proj
        if external is None and any(e.needs_jitter for e in self.effects):
            self.camera.jitter(self.width, self.height, self.frame)
            jit_proj = np.asarray(self.camera.projection_matrix, np.float64).copy()
        prev_world = self._prev_world if self._prev_world is not None else world
        prev_proj = self._prev_proj if self._prev_proj is not None else proj
        for e in self.effects:
            e.host_update(self)
        env = self._resolve_environment()

        unjit = _camera(self.camera, world, proj)
        cam = unjit if jit_proj is proj else _camera(self.camera, world, jit_proj)
        prev_cam = _camera(self.camera, prev_world, prev_proj)
        params = self.build_params(moved)
        if external is None:
            packed, lighting = self._stage_scene()
            image, self._state = self._build_frame_fn(mesh)(
                packed, *self._model_matrices(), cam, unjit, prev_cam,
                self._state, params, self.frame % 4096, env, lighting)
        else:
            image, self._state = self._frame(
                external, mesh, None, None, None, cam, unjit, prev_cam,
                self._state, params, self.frame % 4096, env, None)

        self._prev_world = world
        self._prev_proj = proj
        self._last_world = world
        if external is None:
            self.scene.commit_frame()
        self.frame += 1
        self._reset_pending = False
        return image

    def _build_frame_fn(self, mesh=None):
        """The frame function of the JAX package's method of this name:
        ``frame_fn(packed, model_mats, prev_model_mats, cam, unjit_cam,
        prev_cam, state, params, frame_index, env, lighting) -> (image,
        new_state)``, the frame body of :meth:`render` with its inputs
        given (``params`` as :meth:`build_params` makes them; the
        skinning, morph and alpha inputs come from the scene).

        With ``mesh``, the split frame: ``image`` and every image-like
        leaf of ``new_state`` come back as ``RowBlocks`` (block ``i`` on
        ``mesh[i]``); ``state`` may be given whole or as blocks. Each
        stage runs per shard or whole as ``parallel/__init__.py`` sets out,
        and :attr:`last_placement` reports where."""
        def frame_fn(packed, model_mats, prev_model_mats, cam, unjit_cam,
                     prev_cam, state, params, frame_index, env, lighting):
            return self._frame(None, mesh, packed, model_mats, prev_model_mats,
                               cam, unjit_cam, prev_cam, state, params,
                               int(frame_index), env, lighting)

        return frame_fn

    def _frame(self, external, mesh, packed, model_mats, prev_model_mats, cam,
               unjit_cam, prev_cam, state, params, frame_index, env, lighting):
        """The frame body: raster (or the ``external`` buffers), shade,
        the effect chain; split over ``mesh`` when one is given. Returns
        (image, new state)."""
        timed = []
        sf = (None if mesh is None else
              SplitFrame(tuple(torch.device(d) for d in mesh), self.device,
                         self.height, self.width))

        def stage(name, fn):
            span = tracing.stage(name, self.device, self.collect_timings)
            with span:
                out = fn()
            if span.timed:
                timed.append(span)
            return out

        color = None
        if external is None:
            gbuffer, velocity, color, gi_gbuffer = stage("raster", lambda: self._raster(
                packed, model_mats, prev_model_mats, cam, unjit_cam, prev_cam,
                env, lighting, frame_index, params["__global__"],
                shade=sf is None))
        else:
            (gbuffer, velocity, color), gi_gbuffer = external, None
        if sf is None:
            state = gather_pytree(state, self.device)
        else:
            sf.placement["raster"] = "whole"
            state = sf.split(state)
            gbuffer, velocity, gi_gbuffer = sf.split((gbuffer, velocity,
                                                      gi_gbuffer))
            if color is None:
                color = stage("shade", lambda: sf.map(
                    lambda row0, gb: shade_direct(gb, cam, lighting, env, row0,
                                                  self.height), 0, gbuffer))
                sf.placement["shade"] = "shard"
            else:
                if external is None:
                    sf.placement["shade"] = "whole"
                color = sf.split(color)
        ctx = FrameContext(
            gbuffer=gbuffer, velocity=velocity,
            last_velocity=state["__global__"]["last_velocity"],
            scene_color=color, cam=cam, unjittered_cam=unjit_cam,
            prev_cam=prev_cam, frame_index=frame_index, params=params,
            env=env, gi_gbuffer=gi_gbuffer)

        new_state = {"__global__": {"last_velocity": velocity}}
        image = color
        whole_ctx = None
        for e in self.effects:
            if sf is None:
                run = lambda e=e: e.apply(ctx, image, state[e.name])
            elif e.split_placement() == "shard":
                sf.placement[e.name] = "shard"
                run = lambda e=e: e.apply_split(sf, ctx, image, state[e.name])
            else:
                sf.placement[e.name] = "whole"
                if whole_ctx is None:
                    whole_ctx = sf.gather(ctx)
                run = lambda e=e: sf.split(e.apply(
                    whole_ctx, sf.gather(image), sf.gather(state[e.name])))
            image, new_state[e.name] = stage(e.name, run)
        self._timed_stages = timed
        self.last_placement = {} if sf is None else sf.placement
        return image, new_state

    # ------------------------------------------------------------------
    def state(self, effect_name: str):
        """An effect's state dict (observability hook); row blocks of a
        split frame are joined on the composer's device."""
        if not self._state:
            return None
        return gather_pytree(self._state[effect_name], self.device)

    def save_state(self, path: str):
        """Write the temporal state and frame counters to ``path`` (.npz).
        Resume with :meth:`load_state` on a composer with the same effect
        stack and size."""
        from .convert import flatten_state, state_to_numpy

        if self._state is None:
            raise RuntimeError("no state yet: render at least one frame")
        arrays = flatten_state(state_to_numpy(gather_pytree(self._state,
                                                            self.device)))
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

    # ------------------------------------------------------------------
    def profile(self, trace_dir: str, frames: int = 3):
        """Render ``frames`` frames under ``torch.profiler`` (CPU and, on
        the card, CUDA activity) and write a Chrome trace into
        ``trace_dir`` (the JAX package's ``jax.profiler`` trace); returns
        the trace's path. Tracing stays as it is: off, each ``stage:``
        range holds its stage's device work; on (``tracing.enable()``),
        the trace also carries the ``frame``, ``pass:`` and ``wait:``
        ranges, but the profiler places a device operation under its
        innermost range only, so a stage's device range then keeps just
        the work launched outside its passes."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(trace_dir, exist_ok=True)
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(frames):
                self.render()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        path = os.path.join(trace_dir, f"frames-{self.frame}.pt.trace.json")
        prof.export_chrome_trace(path)
        return path

