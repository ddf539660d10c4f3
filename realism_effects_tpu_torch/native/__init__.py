"""The package's host C++ libraries, compiled with g++ at first use into
``build/native/`` at the checkout root and bound with ctypes:

- ``envcdf.cpp``: the environment's inverse-CDF precompute (the
  reference's Web Worker, `EquirectHdrInfoUniform.js`) and the
  half-float decode; without a compiler :func:`build_equirect_cdf` and
  :func:`half_to_float` return None and the callers take numpy versions
  of the same functions;
- ``draco.cpp``: the Draco mesh decoder (KHR_draco_mesh_compression),
  the fast path of ``scene/draco.py``'s Python decoder, which it equals
  bit for bit; :func:`draco_decode` returns None without it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parents[1] / "build" / "native"


class _Library:
    """One C++ source, built once (its output named by a hash of the
    source and the flags) and loaded; ``bind(lib)`` sets the ctypes
    signatures. A failed build is remembered: ``load()`` returns None."""

    def __init__(self, name: str, flags: tuple, timeout: int, bind):
        self.src = _DIR / f"{name}.cpp"
        self.name, self.flags, self.timeout, self.bind = name, flags, timeout, bind
        self.lock = threading.Lock()
        self.lib = None
        self.failed = False

    def load(self) -> ctypes.CDLL | None:
        with self.lock:
            if self.lib is not None or self.failed:
                return self.lib
            key = hashlib.sha1(self.src.read_bytes() + " ".join(self.flags).encode())
            out = BUILD_DIR / f"{self.name}-{key.hexdigest()[:12]}.so"
            try:
                if not out.exists():
                    BUILD_DIR.mkdir(parents=True, exist_ok=True)
                    tmp = out.with_suffix(f".{os.getpid()}.tmp")
                    subprocess.run(["g++", *self.flags, str(self.src), "-o", str(tmp)],
                                   check=True, capture_output=True,
                                   timeout=self.timeout)
                    os.replace(tmp, out)
                lib = ctypes.CDLL(str(out))
            except (OSError, subprocess.SubprocessError):
                self.failed = True
                return None
            self.bind(lib)
            self.lib = lib
            return lib


def _bind_envcdf(lib):
    lib.build_equirect_cdf.restype = ctypes.c_double
    lib.build_equirect_cdf.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.half_to_float.restype = None
    lib.half_to_float.argtypes = [
        ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
    ]


def _bind_draco(lib):
    lib.re_draco_decode.restype = ctypes.c_void_p
    lib.re_draco_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong, ctypes.c_char_p, ctypes.c_int]
    lib.re_draco_num_points.restype = ctypes.c_longlong
    lib.re_draco_num_points.argtypes = [ctypes.c_void_p]
    lib.re_draco_num_faces.restype = ctypes.c_longlong
    lib.re_draco_num_faces.argtypes = [ctypes.c_void_p]
    lib.re_draco_faces.restype = ctypes.POINTER(ctypes.c_int32)
    lib.re_draco_faces.argtypes = [ctypes.c_void_p]
    lib.re_draco_num_attributes.restype = ctypes.c_int
    lib.re_draco_num_attributes.argtypes = [ctypes.c_void_p]
    lib.re_draco_attribute_info.restype = None
    lib.re_draco_attribute_info.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.re_draco_attribute_floats.restype = ctypes.POINTER(ctypes.c_float)
    lib.re_draco_attribute_floats.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.re_draco_attribute_ints.restype = ctypes.POINTER(ctypes.c_int32)
    lib.re_draco_attribute_ints.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.re_draco_release.restype = None
    lib.re_draco_release.argtypes = [ctypes.c_void_p]


_ENVCDF = _Library("envcdf", ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"),
                   120, _bind_envcdf)
_DRACO = _Library("draco", ("-O2", "-shared", "-fPIC", "-std=c++17"), 240,
                  _bind_draco)


def _load() -> ctypes.CDLL | None:
    return _ENVCDF.load()


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


def half_to_float(half_bits: np.ndarray) -> np.ndarray | None:
    """uint16 half-float bits -> float32 (None without the library)."""
    lib = _load()
    if lib is None:
        return None
    half_bits = np.ascontiguousarray(half_bits, np.uint16)
    out = np.empty(half_bits.shape, np.float32)
    lib.half_to_float(
        half_bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        half_bits.size)
    return out


def draco_available() -> bool:
    """Whether the Draco decoder's library built and loaded."""
    return _DRACO.load() is not None


def draco_decode(data: bytes):
    """Native Draco decode -> (faces (F, 3) int32, {unique_id: array},
    num_points), or None without the library. Raises ValueError on a
    malformed or unsupported bitstream."""
    lib = _DRACO.load()
    if lib is None:
        return None
    err = ctypes.create_string_buffer(256)
    handle = lib.re_draco_decode(data, len(data), err, 256)
    if not handle:
        raise ValueError(f"draco: {err.value.decode()}")
    try:
        num_points = lib.re_draco_num_points(handle)
        num_faces = lib.re_draco_num_faces(handle)
        faces = np.ctypeslib.as_array(
            lib.re_draco_faces(handle), shape=(num_faces, 3)).copy()
        attrs = {}
        for i in range(lib.re_draco_num_attributes(handle)):
            uid = ctypes.c_longlong()
            nc = ctypes.c_int()
            is_float = ctypes.c_int()
            lib.re_draco_attribute_info(
                handle, i, ctypes.byref(uid), ctypes.byref(nc),
                ctypes.byref(is_float))
            get = (lib.re_draco_attribute_floats if is_float.value
                   else lib.re_draco_attribute_ints)
            attrs[int(uid.value)] = np.ctypeslib.as_array(
                get(handle, i), shape=(num_points, nc.value)).copy()
        return faces, attrs, int(num_points)
    finally:
        lib.re_draco_release(handle)
