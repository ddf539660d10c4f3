"""realism_effects_tpu_torch -- the PyTorch/CUDA port of realism_effects_tpu.

The effect chain of the JAX package on NVIDIA Hopper: the same module
layout, option names and tensor layouts, with each TPU kernel rewritten
as a CUDA C++ kernel (``csrc/``) that is built with ``nvcc`` at first use.
Every kernel's wrapper runs a plain PyTorch version of the same function
for tensors on the CPU. The port carries ``render_external`` with
``SSGIEffect`` (under an ``EquirectEnv`` environment), ``HBAOEffect`` and
``TRAAEffect``; the rasterizer and the other effects are not ported yet.
"""

from .composer import EffectComposer, FrameContext
from .core.camera import Camera, CameraMatrices, PerspectiveCamera
from .core.envmap import EquirectEnv, build_equirect_env, procedural_sky
from .core.framebuffers import GBuffer, VelocityBuffer
from .effects.ao import AOEffect, HBAOEffect
from .effects.base import Effect
from .effects.ssgi import SSGIEffect
from .effects.traa import TRAAEffect
from .ops.ao import AOConfig
from .ops.poisson_denoise import PoissonDenoiseConfig, poisson_denoise
from .ops.temporal_reproject import TemporalReprojectConfig, temporal_reproject

__all__ = [
    "EffectComposer", "FrameContext", "Effect", "AOEffect", "HBAOEffect",
    "TRAAEffect", "Camera", "CameraMatrices", "PerspectiveCamera", "GBuffer",
    "VelocityBuffer", "AOConfig", "PoissonDenoiseConfig", "poisson_denoise",
    "TemporalReprojectConfig", "temporal_reproject", "SSGIEffect",
    "EquirectEnv", "build_equirect_env", "procedural_sky",
]
