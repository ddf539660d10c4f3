"""Independent references of the stages, one module a stage.

``port/`` is a frozen copy of the port's own plain route, so it shares
whatever the port's glue does. The modules here do not: each is plain
per-pixel PyTorch written from the upstream shaders and the JAX
package's definitions of the pass (cited in each module), sharing no
code with ``port/`` or with the program. ``check.py`` runs the frozen
copy with each stage's inputs and outputs recorded on one frame, gives
every recorded stage whose effect has a module here the same inputs,
and compares the two outputs: a fault in the port's glue that the copy
carries shows as a gap there.

``<effect name>.py`` defines ``step(record) -> (image, state)``; a
record holds the stage's ``ctx`` (the frame context), ``color`` (its
input image), ``state`` (its state before the frame) and, for SSGI,
``trace`` (the trace's two outputs, which the SSGI module takes as
given: the sweep trace has no independent reference yet).
"""
