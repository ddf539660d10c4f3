"""Independent references of the stages, one module a stage.

``port/`` is a frozen copy of the port's own plain route, so it shares
whatever the port's glue does. The modules here do not: each is plain
per-pixel PyTorch written from the upstream shaders and the JAX
package's definitions of the pass (cited in each module), sharing no
code with ``port/`` or with the program. ``check.py`` runs the frozen
copy with each stage's inputs and outputs recorded on one frame, gives
every recorded stage that has a module here for its mode the same
inputs, and compares the two outputs: a fault in the port's glue that
the copy carries shows as a gap there.

A module is chosen by the stage's name and mode (``check.MODES``):
``<stage>.py`` serves the stage in its default mode (SSGI's and SSR's
sweep traces, ``ssgi_trace.py`` and ``ssr_trace.py``; motion blur's
sweep, ``motion_blur.py``) and in a stage that has no modes,
``<stage>_<mode>.py`` in another
(``ssgi_trace_march.py``, ``motion_blur_taps.py``). A stage in a mode
that has no module, where its default mode has one, stops the check.

Each module defines ``step(record) -> (image, state)``; a record holds
the stage's ``ctx`` (the frame context), ``color`` (its input image),
``state`` (its state before the frame), ``effect`` (the stage's effect,
for its static options), ``mode`` and, for SSGI and SSR, ``trace`` (the
trace's two outputs, which the module of the effect after its trace
takes as given). The trace, SSR and GTAO modules stop the check on an
option of their effect that they do not follow.
"""
