"""The card's peaks and a launch's least time.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet), as the
port's ``chip_smoke.py`` states them: HBM3 at 3.35 TB/s, float32 outside
the tensor cores at 67 TFLOP/s; both at the full 700 W power limit.
"""

from __future__ import annotations

import re

MEM_BW = 3.35e12      # bytes/s
F32_RATE = 67e12      # operations/s


def least_s(nbytes: float, ops: float) -> float:
    """max(bytes / MEM_BW, ops / F32_RATE): the least time of a launch
    (``chip_smoke._bound``)."""
    return max(nbytes / MEM_BW, ops / F32_RATE)


def matches(profiled: str, kernel: str) -> bool:
    """Whether the profiled device operation ``profiled`` is the kernel
    ``kernel`` (its whole identifier, e.g. ``hbao_kernel`` and not
    ``hbao_noise_kernel``)."""
    return re.search(rf"(?<![A-Za-z0-9_]){re.escape(kernel)}(?![A-Za-z0-9_])",
                     profiled) is not None
