"""Per-object motion blur (kernel K12, `MotionBlurEffect.js` +
`shader/motion_blur.frag`): a jittered line integral along the per-pixel
velocity, frame-rate normalised by ``frameSpeed = (1/100)/deltaTime``.

``mode`` picks the discretisation of that integral
(``ops/motion_blur.py``): ``"sweep"`` (the default, the direction-binned
sweep) or ``"taps"`` (the reference's ``samples + 1`` bilinear taps, the
parity mode).
"""

from __future__ import annotations

from ..ops import motion_blur as _op
from ..parallel.sharding import replicate_for_rolls
from .base import Effect


class MotionBlurEffect(Effect):
    name = "motion_blur"

    def __init__(self, intensity: float = 1.0, jitter: float = 1.0,
                 samples: int = 16, mode: str = "sweep",
                 sweep_dirs: int = 16, sweep_steps: int = 12):
        if mode not in ("taps", "sweep"):
            raise ValueError("mode must be 'taps' or 'sweep'")
        self.intensity = intensity
        self.jitter = jitter
        self.samples = int(samples)
        self.mode = mode
        self.sweep_dirs = int(sweep_dirs)
        self.sweep_steps = int(sweep_steps)
        self.delta_time = 1.0 / 60.0

    def static_key(self):
        return (self.samples, self.mode, self.sweep_dirs, self.sweep_steps)

    def host_update(self, composer):
        # measured per-frame dt, already clamped to >= 1 ms by the
        # composer: the reference's `max(1/1000, deltaTime)`
        # (`MotionBlurEffect.js:87-89`)
        self.delta_time = composer.delta_time

    def uniforms(self):
        return {"intensity": float(self.intensity),
                "jitter": float(self.jitter),
                "delta_time": float(self.delta_time)}

    def apply(self, ctx, color, state):
        return self._blur(ctx, color, ctx.velocity.velocity), state

    def _blur(self, ctx, color, velocity, row_offset: int = 0, source=None):
        u = ctx.params[self.name]
        args = dict(intensity=u["intensity"], jitter=u["jitter"],
                    delta_time=u["delta_time"], row_offset=row_offset,
                    source=source)
        if self.mode == "sweep":
            return _op.motion_blur_sweep(color, velocity, ctx.frame_index,
                                         dirs=self.sweep_dirs,
                                         steps=self.sweep_steps, **args)
        return _op.motion_blur(color, velocity, ctx.frame_index,
                               samples=self.samples, **args)

    def split_placement(self):
        return "shard"

    def apply_split(self, sf, ctx, color, state):
        """The colour gathered once (``replicate_for_rolls``: a blur
        reads up to a quarter of the diagonal away, the taps anywhere);
        each shard blurs its own rows from it."""
        source = replicate_for_rolls(color, device=sf.home)
        out = sf.map(lambda row0, c, v, src: self._blur(ctx, c, v, row0, src),
                     0, color, ctx.velocity.velocity, source)
        return out, state
