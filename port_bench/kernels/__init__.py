"""Each CUDA kernel's bytes and operations a launch:
``kernels/<kernel>.py`` defines ``NAME`` (the kernel's identifier in the
profile) and ``cost(params) -> (bytes, operations)`` for the launch shape
``params`` of a cell's ``kernel_launches`` table. Bytes count each input
read once and each output written once; operations count what every
launch of that shape must do, and leave out work that depends on the
data, so the least time is never above what the inputs need. The
formulas are those of the port's ``chip_smoke.py``."""
