"""The frozen plain route (see ``port_bench/reference/__init__.py``)."""

from .composer import EffectComposer
from .core.camera import PerspectiveCamera
from .core.envmap import build_equirect_env
from .effects.ao import GTAOEffect, HBAOEffect
from .effects.motion_blur import MotionBlurEffect
from .effects.ssgi import SSGIEffect, SSREffect
from .effects.taa import TAAPass
from .effects.traa import TRAAEffect
from .scene.geometry import Material, Mesh
from .scene.scene import Scene
