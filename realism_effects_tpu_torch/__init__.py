"""realism_effects_tpu_torch -- the PyTorch/CUDA port of realism_effects_tpu.

The effect chain of the JAX package on NVIDIA Hopper: the same module
layout, option names and tensor layouts, with each TPU kernel rewritten
as a CUDA C++ kernel (``csrc/``) that is built with ``nvcc`` at first use.
Every kernel's wrapper runs a plain PyTorch version of the same function
for tensors on the CPU. ``EffectComposer.render`` rasterizes a
``Scene`` (built in code or loaded from glTF by ``load_gltf`` /
``load_gltf_asset``, Draco meshes included, and animated by an
``AnimationMixer``; stochastic alpha with ``alpha_peels`` depth peels,
supersampled with ``msaa``) seen by a ``PerspectiveCamera`` or an
``OrthographicCamera``, shades it and runs ``SSGIEffect`` and
``SSREffect`` (traced by the direction-binned sweep or, with
``trace="march"``, the reference's per-pixel march), ``HBAOEffect``,
``GTAOEffect``, ``MotionBlurEffect``, ``TRAAEffect``, ``TAAPass``,
``FXAAEffect``, ``SMAAEffect``, the finishing effects
(``SharpnessEffect``, ``LensDistortionEffect``, ``SparkleEffect``,
``GradualBackgroundEffect``) and the reference demo's companion post-FX
(``ToneMappingEffect``, ``VignetteEffect``, ``BloomEffect``,
``LUT3DEffect``); ``render_external`` runs the effects on buffers the
caller supplies. The environment is an ``EquirectEnv``, an equirect map
or a cube map's six faces (``cube_to_equirect``; ``blur_env`` blurs a
map as the reference demo does).
"""

from .composer import EffectComposer, FrameContext
from .core.camera import (Camera, CameraMatrices, OrthographicCamera,
                          PerspectiveCamera)
from .core.envmap import (EquirectEnv, blur_env, build_equirect_env,
                          cube_to_equirect, equirect_to_cube, load_cubemap,
                          procedural_sky)
from .core.framebuffers import GBuffer, VelocityBuffer
from .effects.ao import AOEffect, GTAOEffect, HBAOEffect
from .effects.base import Effect
from .effects.fxaa import FXAAEffect
from .effects.smaa import SMAAEffect
from .effects.finishing import (GradualBackgroundEffect, LensDistortionEffect,
                                SharpnessEffect, SparkleEffect)
from .effects.motion_blur import MotionBlurEffect
from .effects.postfx import (BloomEffect, LUT3DEffect, ToneMappingEffect,
                             VignetteEffect, load_lut_3dl)
from .effects.ssgi import SSGI_PRESETS, SSGIEffect, SSREffect
from .effects.taa import TAAPass
from .effects.traa import TRAAEffect
from .ops.ao import AOConfig
from .ops.poisson_denoise import PoissonDenoiseConfig, poisson_denoise
from .ops.temporal_reproject import TemporalReprojectConfig, temporal_reproject
from .scene.animation import AnimationClip, AnimationMixer
from .scene.geometry import (Material, Mesh, make_box, make_plane, make_sphere,
                             rotation_x, rotation_y, scale, translation)
from .scene.gltf import GltfAsset, load_gltf, load_gltf_asset, write_glb
from .scene.rasterizer import rasterize_gbuffer, rasterize_velocity
from .scene.scene import PackedScene, Scene
from .scene.shading import shade_direct
from .utils.debug import visualize_gbuffer, visualize_velocity
from .utils.image_io import save_frame, write_png

__all__ = [
    "EffectComposer", "FrameContext", "Effect", "AOEffect", "HBAOEffect",
    "TRAAEffect", "CameraMatrices", "PerspectiveCamera", "GBuffer",
    "VelocityBuffer", "PoissonDenoiseConfig", "poisson_denoise",
    "TemporalReprojectConfig", "temporal_reproject", "SSGIEffect",
    "EquirectEnv", "build_equirect_env", "procedural_sky", "MotionBlurEffect",
    "Scene", "Material", "Mesh", "make_plane", "make_box",
    "make_sphere", "translation", "rotation_y", "rasterize_gbuffer",
    "rasterize_velocity", "shade_direct", "SharpnessEffect",
    "LensDistortionEffect", "SparkleEffect", "GradualBackgroundEffect",
    "ToneMappingEffect", "VignetteEffect", "BloomEffect", "LUT3DEffect",
    "load_lut_3dl", "SSREffect", "GTAOEffect", "TAAPass",
    "OrthographicCamera", "FXAAEffect", "SMAAEffect", "equirect_to_cube",
    "cube_to_equirect", "blur_env", "load_cubemap", "rotation_x", "scale",
    "SSGI_PRESETS", "visualize_gbuffer", "visualize_velocity", "save_frame",
    "write_png", "load_gltf", "load_gltf_asset", "GltfAsset", "AnimationMixer",
    "AnimationClip", "write_glb",
]
