"""Effect protocol: ``apply(ctx, color, state) -> (color, state)``.

As in the JAX package, options are split the way the reference splits
defines and uniforms (`SSGIEffect.js:157-268`): static options are
attributes (``static_key``), per-frame scalars come from
:meth:`Effect.uniforms` as host floats.
"""

from __future__ import annotations


class Effect:
    name: str = "effect"
    #: effect wants the camera R2-jittered each frame (TRAA)
    needs_jitter: bool = False

    def init_state(self, height: int, width: int, device) -> dict:
        """Initial per-effect state (history buffers etc.)."""
        return {}

    def uniforms(self) -> dict:
        """Per-frame scalars (uniform-like options)."""
        return {}

    def static_key(self) -> tuple:
        """Hashable key of define-like options."""
        return ()

    def host_update(self, composer) -> None:
        """Host-side per-frame hook, before the device work."""

    def apply(self, ctx, color, state: dict):
        """Returns (new_color (H, W, 3), new_state)."""
        raise NotImplementedError
