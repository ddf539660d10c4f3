"""The environment's inverse-CDF precompute in C++ (``envcdf.cpp``, the
reference's Web Worker, `EquirectHdrInfoUniform.js`), compiled with g++
at first use into ``build/native/`` at the checkout root and bound with
ctypes. Without a compiler :func:`build_equirect_cdf` returns None and
``core/envmap.py`` takes its numpy version of the same tables."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "envcdf.cpp"
BUILD_DIR = _SRC.parents[2] / "build" / "native"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None
_build_failed = False


def _load() -> ctypes.CDLL | None:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        key = hashlib.sha1(_SRC.read_bytes() + " ".join(_FLAGS).encode())
        out = BUILD_DIR / f"envcdf-{key.hexdigest()[:12]}.so"
        try:
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, out)
            lib = ctypes.CDLL(str(out))
        except (OSError, subprocess.SubprocessError):
            _build_failed = True
            return None
        lib.build_equirect_cdf.restype = ctypes.c_double
        lib.build_equirect_cdf.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the C++ library built and loaded."""
    return _load() is not None


def build_equirect_cdf(rgb: np.ndarray, num_threads: int = 0):
    """Marginal (H,) and conditional (H, W) inverse-CDF tables and the
    total luminance of an (H, W, 3) float32 map; None without the
    library."""
    lib = _load()
    if lib is None:
        return None
    rgb = np.ascontiguousarray(rgb, np.float32)
    h, w = rgb.shape[:2]
    marginal = np.empty(h, np.float32)
    conditional = np.empty((h, w), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    total = lib.build_equirect_cdf(
        rgb.ctypes.data_as(fp), w, h, num_threads,
        marginal.ctypes.data_as(fp), conditional.ctypes.data_as(fp))
    return marginal, conditional, float(total)
