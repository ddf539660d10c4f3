"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by hand
with ``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/<name>-<hash>.so``
at the checkout root (the hash covers the source and the flags, so an
edited source never loads a stale library). The libraries are loaded
with ``ctypes``. All sources are compiled together, one ``nvcc`` process
each, the first time any kernel is needed.

Flags: ``-O3``; no ``--use_fast_math`` (HBAO and Poisson need libm's
``sinf``/``expf``/``logf``); ``-fmad=false`` so that every product and sum
rounds on its own, in the order the plain PyTorch version computes it.

Every wrapper in ``ops/`` launches through :func:`launch`, which counts
each launch under a name in :data:`launches` (``launches.clear()``
empties it); the plain versions that CPU tensors take launch nothing.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = ("warp", "stencil", "hbao", "poisson", "sweep", "raster", "table",
           "taps", "motion_blur", "reproject", "shade")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: ``nvcc -Xptxas -v`` report of each build (registers, spills)
build_log: dict[str, str] = {}
#: the kernel launches since the last ``launches.clear()``, by name
launches: collections.Counter = collections.Counter()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from csrc/ at first use")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    common = (CSRC / "common.cuh").read_bytes()
    key = hashlib.sha1(src + common + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{key.hexdigest()[:12]}.so"


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile (where not yet built) and load every kernel library.
    The compiles run in parallel; any failure raises with nvcc's output."""
    with _lock:
        todo = [n for n in SOURCES if n not in _libs]
        if not todo:
            return _libs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in todo:
            out = _target(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        errors = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            build_log[name] = log
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n{log}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        for name in todo:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (builds all at first use)."""
    lib = _libs.get(name)
    return lib if lib is not None else build_all()[name]


def bind(name: str, fn: str, n_ptr: int, n_int: int, n_host_ptr: int = 0):
    """The C entry point ``fn`` of ``csrc/<name>.cu`` with its ctypes
    signature: ``n_ptr`` device pointers, ``n_int`` ints, ``n_host_ptr``
    host pointers, then the stream; it returns a ``cudaError_t``."""
    f = getattr(library(name), fn)
    if f.argtypes is None:
        f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                      + [ctypes.c_void_p] * (n_host_ptr + 1))
        f.restype = ctypes.c_int
    return f


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(key: str, source: str, fn: str, sig: tuple, like: torch.Tensor,
           *args) -> None:
    """Call the C entry ``fn`` of ``csrc/<source>.cu``, bound with the
    counts ``sig`` of :func:`bind`, on ``args`` and the current stream of
    ``like``'s device; raise on a non-zero ``cudaError_t``; count one
    launch of ``key``."""
    err = bind(source, fn, *sig)(*args, stream_ptr(like))
    if err != 0:
        raise RuntimeError(f"{key} kernel: CUDA launch failed with error {err}")
    launches[key] += 1


def require_cuda(*tensors: torch.Tensor):
    """Validate tensors for a kernel: float32/int32/float16, contiguous,
    one CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, not {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
        if t.dtype not in (torch.float32, torch.int32, torch.float16):
            raise ValueError("kernel inputs must be float32/int32/float16, "
                             f"not {t.dtype}")
