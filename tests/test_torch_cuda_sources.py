"""The CUDA kernels' sources, compiled for the host, vs the plain versions.

There is no CUDA compiler or card on the CPU test machines, but the
kernels in ``realism_effects_tpu_torch/csrc`` use only a small part of
CUDA. A shim header defines those builtins for g++ and each launch
``kernel<<<grid, block, 0, stream>>>(...)`` becomes a loop over the grid,
so each kernel's own arithmetic runs here through its real C entry point
and wrapper launch code, and is held against the plain PyTorch version.
Tolerances: warp (one target and many), minmax, sharpness, the sweep
march, the z-scan, the record fetch, the Poisson tap fetch, motion
blur's accumulate pass and its taps are bit-identical (same operations
in the same order, no contraction but the explicit ``fmaf``:
``-ffp-contract=off`` as ``-fmad=false`` on the card); HBAO
and Poisson agree to 2e-5, the gap
between glibc's and PyTorch's sin/cos/exp/log. SSGI's shade kernel is
bit-identical against its plain route run with glibc's atan2f, acosf,
sqrtf and powf (its libm calls, the host build's), and within 2e-5
(1e-5 relative) with PyTorch's own, the same gap. The per-pixel ray march
is bit-identical against its plain route run with glibc's ``expf`` (its
one libm call, the host build's); with PyTorch's own ``exp``, which
differs from glibc's by an ulp in about 1% of arguments, an ulp moves a
step and can flip a hit decided at a texel boundary, so at most
MARCH_FLIP_FRAC of lanes may differ in their hit and the others agree to
MARCH_MEAN_TOL on average. The card itself is checked
by chip_smoke.py. The host build checks the alignment of every 16-byte
load and store (``-fsanitize=alignment``, aborting on the first), which
the card would refuse at run time: a vector route taken without its
alignment check fails here too.
"""

import collections
import ctypes
import ctypes.util
import dataclasses
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from realism_effects_tpu_torch.core.camera import OrthographicCamera, PerspectiveCamera
from realism_effects_tpu_torch.core.framebuffers import GBuffer
from realism_effects_tpu_torch import analytic
from realism_effects_tpu_torch.core import math3d
from realism_effects_tpu_torch.ops import (cuda_build, hbao_kernel,
                                           march_kernel, motion_blur,
                                           poisson_kernel, poisson_taps,
                                           raster_kernel, shade_kernel, ssgi,
                                           ssgi_sweep, stencil, sweep_kernel,
                                           table_kernel, warp)
from realism_effects_tpu_torch.scene import rasterizer
from realism_effects_tpu_torch.ops.ao import AOConfig
from realism_effects_tpu_torch.ops.cuda_build import launches
from realism_effects_tpu_torch.ops.poisson_denoise import (POISSON8,
                                                           PoissonDenoiseConfig)

SHIM = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static dim3 blockIdx, threadIdx, blockDim, gridDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum { cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
inline int cudaGetLastError() { return 0; }
template <class F> inline int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
// the H100's opt-in limit, 227 KB
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 232448; return 0; }
inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; memcpy(&u, &f, 4); return u; }
struct __half { unsigned short b; };
inline __half __ushort_as_half(unsigned short s) { __half h; h.b = s; return h; }
inline float __half2float(__half h) { _Float16 v; memcpy(&v, &h.b, 2); return (float)v; }
inline __half __float2half_rn(float f) {
  _Float16 v = (_Float16)f; __half h; memcpy(&h.b, &v, 2); return h;
}
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
// threads run one after another: a block's shared table is filled whole
// by its first thread (common.cuh's block helpers have host twins)
#define RE_HOST_SEQUENTIAL
#define RE_DYNAMIC_SHARED(T, name) static T name[1 << 16]
namespace re {
inline void block_load(float* d, const float* s, int n) {
  for (int i = 0; i < n; ++i) d[i] = s[i];
}
}  // namespace re
struct GridLoop {
  dim3 g, b; unsigned long long i = 0, n;
  GridLoop(dim3 g_, dim3 b_) : g(g_), b(b_) {
    n = (unsigned long long)g.x * g.y * g.z * b.x * b.y * b.z;
    gridDim = g; blockDim = b;
  }
  bool next() {
    if (i >= n) return false;
    unsigned long long k = i++;
    threadIdx.x = k % b.x; k /= b.x; threadIdx.y = k % b.y; k /= b.y;
    threadIdx.z = k % b.z; k /= b.z; blockIdx.x = k % g.x; k /= g.x;
    blockIdx.y = k % g.y; blockIdx.z = k / g.y;
    return true;
  }
};
#define GRID_LOOP(g, b) for (GridLoop grid_loop_(g, b); grid_loop_.next();)
"""
LAUNCH = re.compile(
    r"(\w+(?:<[^<>]*>)?)<<<\s*([^,]+?)\s*,\s*([^,]+?)\s*,[^>]*>>>\(")


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """The sources built for the host, one g++ each, in parallel."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel sources for the host")
    d = tmp_path_factory.mktemp("cuda_host")
    (d / "shim.h").write_text(SHIM)
    for name in ("cuda_runtime.h", "cuda_fp16.h"):
        (d / name).write_text('#pragma once\n#include "shim.h"\n')
    procs = {}
    for name in cuda_build.SOURCES:
        src = (cuda_build.CSRC / f"{name}.cu").read_text()
        (d / f"{name}.cpp").write_text(LAUNCH.sub(r"GRID_LOOP(\2, \3) \1(", src))
        cmd = [gxx, "-std=c++17", "-O1", "-ffp-contract=off",
               "-fsanitize=alignment", "-fno-sanitize-recover=alignment", "-shared",
               "-fPIC", "-w", "-I", str(d), "-I", str(cuda_build.CSRC),
               "-o", str(d / f"lib{name}.so"), str(d / f"{name}.cpp")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{name}.cu:\n{log}"
    return {n: ctypes.CDLL(str(d / f"lib{n}.so")) for n in cuda_build.SOURCES}


@pytest.fixture
def host_kernels(host_libs, monkeypatch):
    """Route the wrappers' launch code to the host builds."""
    monkeypatch.setattr(cuda_build, "library", lambda name: host_libs[name])
    monkeypatch.setattr(cuda_build, "require_cuda", lambda *t: None)
    monkeypatch.setattr(cuda_build, "stream_ptr", lambda t: None)


def _warp_inputs(c, seed=0, near=False, offset=0):
    """A 37 x 61 texture of c channels and its targets: ``near`` most
    within +-6 rows and +-25 columns of the pixel (so inside the window)
    and a fifth anywhere, else all far (most outside the window and the
    frame); ``offset`` 1: the texture a view 4 bytes into its storage,
    so not 16-byte aligned."""
    rng = np.random.default_rng(seed)
    h, w = 37, 61
    t = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt)
    vals = t(rng.normal(size=(h, w, c)))
    tex = torch.empty(vals.numel() + offset)[offset:].view(h, w, c).copy_(vals)
    assert (tex.data_ptr() % 16 == 0) == (offset == 0)
    ty = rng.integers(-20, h + 20, (h, w))
    tx = rng.integers(-200, w + 200, (h, w))
    if near:
        far = rng.random((h, w)) < 0.2
        ty = np.where(far, ty, np.arange(h)[:, None] + rng.integers(-6, 7, (h, w)))
        tx = np.where(far, tx, np.arange(w)[None, :] + rng.integers(-25, 26, (h, w)))
    return (tex[..., 0] if c == 1 else tex), t(ty, torch.int32), \
        t(tx, torch.int32), t(rng.random((h, w))), t(rng.random((h, w)))


# (channels, near targets, texture offset): far targets keep the ids of
# the first cases; the 4-byte offset sends a C = 4 texture through the
# 4-byte loads instead of the 16-byte ones
WARP_CASES = [pytest.param(c, near, offset,
                           id=("near-" if near else "") + str(c) + ("-offset" if offset else ""))
              for c in (1, 3, 4, 8) for near in (False, True) for offset in (0, 1)
              if offset == 0 or c == 4]


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "catrom", "catrom5"])
@pytest.mark.parametrize("kx", [None, 5])
@pytest.mark.parametrize("c,near,offset", WARP_CASES)
def test_warp_source(host_kernels, mode, kx, c, near, offset):
    args = _warp_inputs(c, near=near, offset=offset)
    got, got_ok = warp._launch(*args, 8, mode, kx)
    want, want_ok = warp.window_warp_plain(*args, 8, mode, kx)
    assert bool(want_ok.float().mean() > 0.5) == (near and kx is None)
    assert torch.equal(got_ok, want_ok)
    assert torch.equal(got, want)


@pytest.mark.parametrize("radius", [1, 2, 5])
def test_minmax_source(host_kernels, radius):
    tex = _warp_inputs(4, seed=radius)[0].clone()
    tex[..., 0][torch.rand(tex.shape[:2], generator=torch.Generator().manual_seed(0)) < 0.3] = -1.0
    tex[5:12, 10:20, 0] = -1.0
    got = stencil._launch(tex, radius)
    want = stencil.neighborhood_minmax_plain(tex, radius)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _same(a, b):
    """Equal values, NaN where the other is NaN (a NaN's bits may differ)."""
    return torch.equal(torch.isnan(a), torch.isnan(b)) and \
        torch.equal(torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


@pytest.mark.parametrize("radius,c,misaligned", [
    (1, 4, False), (2, 4, True), (2, 3, False), (5, 4, False), (49, 8, False)])
def test_minmax_source_planted(host_kernels, radius, c, misaligned):
    """Masked texels (channel 0 < 0) and NaN texels, in channel 0 (so
    masked) and in the others (so propagated to every window that holds
    them), on a 37 x 61 frame that the 32 x 16 tiles do not divide. At
    r = 49 and 8 channels the row pass would need more than the card's
    227 KB opt-in limit of shared memory, and the taps are loaded
    directly; a texel array that starts 4 bytes past a 16-byte boundary
    is read without vector loads."""
    h, w = 37, 61
    rng = np.random.default_rng(10 * radius + c)
    tex = rng.normal(size=(h, w, c)).astype(np.float32)
    tex[..., 0][rng.random((h, w)) < 0.2] = -1.0
    tex[6:9, 40:52, 0] = -3.0
    tex[rng.integers(0, h, 4), rng.integers(0, w, 4), 0] = np.nan
    iy, ix = rng.integers(0, h, 3), rng.integers(0, w, 3)
    tex[iy, ix, 0] = 0.5
    tex[iy, ix, c - 1] = np.nan
    t = torch.tensor(tex)
    if misaligned:
        buf = torch.empty(t.numel() + 1)
        t = buf[1:].view(h, w, c).copy_(t)
        assert t.data_ptr() % 16 != 0
    got = stencil._launch(t, radius)
    want = stencil.neighborhood_minmax_plain(t, radius)
    assert bool(torch.isnan(want[0]).any()) and not bool(torch.isnan(want[0]).all())
    assert _same(got[0], want[0]) and _same(got[1], want[1])


def _sharpness_input(h, w, c, offset, seed):
    """An (h, w, c) image of normal values with a zero pixel, ``offset``
    floats into its storage (1: not 16-byte aligned)."""
    vals = torch.tensor(np.random.default_rng(seed).normal(size=(h, w, c)),
                        dtype=torch.float32)
    vals[h // 2, w // 3] = 0.0
    tex = torch.empty(vals.numel() + offset)[offset:].view(h, w, c).copy_(vals)
    assert (tex.data_ptr() % 16 == 0) == (offset == 0)
    return tex


# (h, w, c, s, offset): the first three keep their ids (a 37 x 61
# frame: w c % 4 != 0, so each float moves on its own); then the 16-byte
# route at C = 1..4 (64 columns), frames of 2, 3 and 38 rows (a thread
# walks two: 3 leaves one for the last thread, 37 and 38 span the block's
# two threads of rows), one float a row short of a 16-byte unit, h = 1,
# w = 1, an image 4 bytes into its storage, and frames of several blocks
# in both directions, on the 16-byte route and off it
SHARPNESS_CASES = [
    pytest.param(37, 61, 3, 1.0, 0, id="3-1.0"),
    pytest.param(37, 61, 3, 0.75, 0, id="3-0.75"),
    pytest.param(37, 61, 1, 2.5, 0, id="1-2.5"),
    *[pytest.param(37, 64, c, 1.0, 0, id=f"vec-c{c}") for c in (1, 2, 3, 4)],
    *[pytest.param(h, 64, 3, 0.75, 0, id=f"vec-c3-h{h}") for h in (2, 3, 38)],
    pytest.param(37, 59, 2, 1.0, 0, id="ragged-c2"),
    pytest.param(37, 63, 4, 1.0, 0, id="vec-c4-w63"),
    pytest.param(37, 62, 2, 1.0, 0, id="vec-c2-w62"),
    pytest.param(1, 64, 3, 1.0, 0, id="h1-c3"),
    pytest.param(1, 61, 4, 1.0, 0, id="h1-c4"),
    pytest.param(37, 1, 3, 1.0, 0, id="w1-c3"),
    pytest.param(37, 1, 4, 1.0, 0, id="w1-c4"),
    pytest.param(1, 1, 2, 1.0, 0, id="h1-w1"),
    pytest.param(37, 64, 4, 1.0, 1, id="offset-c4"),
    pytest.param(37, 64, 3, 0.5, 1, id="offset-c3"),
    pytest.param(21, 704, 3, 1.0, 0, id="blocks-c3"),
    pytest.param(21, 701, 4, 1.0, 1, id="blocks-c4-offset"),
]


@pytest.mark.parametrize("h,w,c,s,offset", SHARPNESS_CASES)
def test_sharpness_source(host_kernels, h, w, c, s, offset):
    if (h, w, offset) == (37, 61, 0):
        # the first cases' input: a 37 x 61 texture, absolute values
        tex = _warp_inputs(max(c, 2), seed=c)[0][..., :c].contiguous().abs()
        tex[3, 4] = 0.0
    else:
        tex = _sharpness_input(h, w, c, offset, seed=h * w * c + offset)
    got = stencil._launch_sharpness(tex, s)
    want = stencil.sharpness_3x3_plain(tex, s)
    assert bool((want == 0.0).any()) or h * w == 1
    assert torch.equal(got, want)


def test_sharpness_refuses_bad_shapes(host_kernels):
    """The C entry refuses 5 channels, an empty frame and 2^31 floats
    before reading a pointer."""
    fn = cuda_build.bind("stencil", "re_sharpness", 2, 3, 1)
    s = np.array([1.0], np.float32)
    for h, w, c in ((4, 4, 5), (0, 4, 3), (4, 0, 1), (1 << 15, 1 << 15, 2)):
        assert fn(0, 0, h, w, c, s.ctypes.data, None) != 0


@pytest.mark.parametrize("kx", [None, 3, 40])
@pytest.mark.parametrize("c", [1, 4])
def test_warp_multi_source(host_kernels, kx, c):
    """8 targets a pixel, near and far (beyond the frame and the +-2^20
    clip), on a 37 x 61 texture with ky = 5."""
    rng = np.random.default_rng(c)
    h, w, n = 37, 61, 8
    tex = torch.tensor(rng.normal(size=(h, w, c)), dtype=torch.float32)
    tex = tex[..., 0] if c == 1 else tex
    ty = torch.tensor(np.arange(h)[None, :, None] + rng.integers(-9, 10, (n, h, w)),
                      dtype=torch.int32)
    tx = torch.tensor(np.arange(w)[None, None, :] + rng.integers(-90, 91, (n, h, w)),
                      dtype=torch.int32)
    ty[0, 0, :5] = torch.tensor([-(1 << 30), 1 << 30, -50, h + 40, 2_000_000])
    tx[1, 3, :3] = torch.tensor([-(1 << 30), 1 << 30, w + 500])
    got, got_ok = warp._launch_multi(tex, ty, tx, 5, kx)
    want, want_ok = warp.window_warp_multi_plain(tex, ty, tx, 5, kx)
    assert torch.equal(got_ok, want_ok) and not bool(want_ok.all())
    assert torch.equal(got, want)


def _tap_targets(h, w, n, radius, rng):
    """n tap targets a pixel of an h x w frame: ``radius`` None anywhere
    in the frame, else as the denoiser places them (a Poisson offset
    rotated by a per-pixel angle, times the radius and a flatness in
    [0.25, 1], in uv at the frame's aspect), not clamped; plus targets
    negative, at the int32 extremes and past the edge."""
    if radius is None:
        iy = rng.integers(0, h, (n, h, w))
        ix = rng.integers(0, w, (n, h, w))
    else:
        ang = rng.random((h, w)) * 2 * np.pi
        scale = radius * (0.25 + 0.75 * rng.random((h, w)))
        u = (np.arange(w) + 0.5) / w
        v = (np.arange(h)[:, None] + 0.5) / h
        off = POISSON8[np.arange(n) % 8]
        ox = (np.cos(ang) * off[:, 0, None, None] / w
              + np.sin(ang) * off[:, 1, None, None] / h) * scale
        oy = (-np.sin(ang) * off[:, 0, None, None] / w
              + np.cos(ang) * off[:, 1, None, None] / h) * scale
        ix = np.floor((u + ox) * w)
        iy = np.floor((v + oy) * h)
    iy, ix = iy.astype(np.int32), ix.astype(np.int32)
    iy[0, 0, :4] = [-1, h, -(1 << 31), (1 << 31) - 1]
    ix[0, 1, :4] = [-7, w + 3, (1 << 31) - 1, -(1 << 31)]
    return torch.tensor(iy), torch.tensor(ix)


# (channels, target radius (None: anywhere), taps, bundle offset): the
# uniform targets keep the ids of the first cases; radius 3 lands in a
# tile's neighbourhood (up to 3 rows and 5 columns away here), radius 12
# well past it (12 rows, 20 columns); 11 taps take two blocks along z
TAPS_CASES = (
    [pytest.param(c, None, 8, 0, id=str(c)) for c in (1, 4, 5, 7, 8)]
    + [pytest.param(c, r, 8, 0, id=f"r{r}-{c}") for r in (3, 12) for c in (1, 4, 5, 7, 8)]
    + [pytest.param(c, 3, 1, 0, id=f"r3-n1-{c}") for c in (4, 5)]
    + [pytest.param(c, 12, 8, 1, id=f"r12-offset-{c}") for c in (4, 5)]
    + [pytest.param(c, 12, 11, 0, id=f"r12-n11-{c}") for c in (4, 5)])


@pytest.mark.parametrize("c,radius,n,offset", TAPS_CASES)
def test_poisson_taps_source(host_kernels, c, radius, n, offset):
    """A 37 x 61 frame, whose 32 x 8 tiles the edge cuts."""
    rng = np.random.default_rng(c + n + (radius or 0))
    h, w = 37, 61
    vals = torch.tensor(rng.normal(size=(h, w, c)), dtype=torch.float32)
    bundle = torch.empty(vals.numel() + offset)[offset:].view(h, w, c).copy_(vals)
    assert (bundle.data_ptr() % 16 == 0) == (offset == 0)
    iy, ix = _tap_targets(h, w, n, radius, rng)
    got = poisson_taps._launch(bundle, iy, ix)
    assert torch.equal(got, poisson_taps.poisson_taps_plain(bundle, iy, ix))


@pytest.mark.parametrize("n,h,w,c,ok", [
    (8, 2048, 16384, 8, False), (1 << 28, 1, 1, 8, False), (1, 1, 1, 9, False),
    (0, 1080, 1920, 5, True)])
def test_poisson_taps_refuses_past_int32(host_kernels, n, h, w, c, ok):
    """The kernel's indices are 32-bit: the entry point refuses an output
    of 2^31 floats or more, and more than 8 channels, before it reads a
    pointer (none is given here); no taps is no launch."""
    fn = cuda_build.bind("taps", "re_poisson_taps", 4, 4)
    assert fn(None, None, None, 16, h, w, c, n, None) == (0 if ok else 1)


def _surface(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    depth = 0.85 + 0.1 * (xx > w // 2) + 0.002 * np.sin(yy * 0.2)
    depth[: h // 8] = 1.0
    nrm = np.array([0.1, 0.2, 0.97]) + rng.uniform(-0.1, 0.1, (h, w, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[: h // 8] = 0.0
    return (torch.tensor(depth, dtype=torch.float32),
            torch.tensor(nrm, dtype=torch.float32))


@pytest.mark.parametrize("cfg", [
    AOConfig(distance=0.3),
    AOConfig(spp=3, window_ky=4, window_kx=3, animated_noise=False),
    AOConfig(spp=40, distance=0.3)])
def test_hbao_source(host_kernels, cfg):
    """Two configurations of one launch, and spp 40: two launches, the
    second going on from the sums the first carried."""
    _hbao_case(cfg)


def _hbao_case(cfg):
    h, w = 48, 80
    depth, nrm = _surface(h, w, 1)
    cam = PerspectiveCamera(50, w / h, 0.1, 80)
    cam.set_position(0.3, 1.5, 5.0)
    cam.look_at((0, 0.5, 0))
    m = cam.matrices()
    got = hbao_kernel._launch(depth, nrm, m, 3, cfg)
    want = hbao_kernel.hbao_fused_plain(depth, nrm, m, 3, cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5)


def test_hbao_source_noise_settings(host_kernels):
    """Two distance / distance_power settings one after the other, and
    the first again: each launch reads the noise table of its own
    setting (a table cached under the wrong key shows here)."""
    for cfg in (AOConfig(distance=0.3), AOConfig(distance=1.7, distance_power=2.5),
                AOConfig(distance=0.3)):
        _hbao_case(cfg)


def test_hbao_noise_table_source(host_kernels):
    """The noise table's entry against torch's sqrt, sin, cos, exp and
    log of the same texels."""
    table = hbao_kernel.noise_table("cpu", 0.7, 2.25)
    tile = hbao_kernel.blue_noise_tile_tensor("cpu")
    want = hbao_kernel.noise_table_plain(tile, 0.7, 2.25)
    assert table.shape == (128, 128, 4) and bool((tile[..., 2] > 0).all())
    np.testing.assert_allclose(table.numpy(), want.numpy(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("row0,hg,spp", [(-32, 80, 8), (24, 80, 3), (40, 96, 40)])
def test_hbao_source_row_block(host_kernels, row0, hg, spp):
    """A 48-row block of a taller frame at global row ``row0`` (negative:
    the first shard's block, extended by its halo), its uv, sample rows
    and noise the frame's, against the plain version with the same
    offset; the re-based targets stay inside the block."""
    h, w = 48, 80
    depth, nrm = _surface(h, w, 4)
    cam = PerspectiveCamera(50, w / hg, 0.1, 80)
    cam.set_position(0.3, 1.5, 5.0)
    cam.look_at((0, 0.5, 0))
    m = cam.matrices()
    cfg = AOConfig(spp=spp, window_ky=6, distance=0.3)
    got = hbao_kernel._launch(depth, nrm, m, 3, cfg, row0, hg)
    want = hbao_kernel.hbao_fused_plain(depth, nrm, m, 3, cfg, row0, hg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5)
    unsharded = hbao_kernel.hbao_fused_plain(depth, nrm, m, 3, cfg)
    assert float((want - unsharded).abs().max()) > 1e-3


@pytest.mark.parametrize("row0,hg", [(-12, 96), (30, 96), (50, 120)])
@pytest.mark.parametrize("slots", [(False, False), (True,)])
def test_poisson_source_row_block(host_kernels, slots, row0, hg):
    """The pass on a 45-row block of a taller frame at global row
    ``row0``: the flatness's bottom edge, the uv and the taps' frame
    clamp of the frame, the tap rows re-based onto the block, the noise
    rolled by ``row0``; against the plain version with the same offset."""
    h, w = 45, 83
    rng = np.random.default_rng(row0 + hg)
    depth, nrm = _surface(h, w, 6)
    z = torch.zeros
    gb = GBuffer(diffuse=z(h, w, 4), normal=nrm,
                 roughness=torch.tensor(rng.random((h, w)), dtype=torch.float32),
                 metalness=z(h, w), emissive=z(h, w, 3), depth=depth)
    texs = [torch.tensor(np.concatenate(
        [rng.random((h, w, 3)) * 2, rng.integers(0, 40, (h, w, 1))], -1),
        dtype=torch.float32) for _ in slots]
    if slots == (True,):
        texs = [texs[0][..., [0, 0, 0, 3]]]
    cfg = dataclasses.replace(PoissonDenoiseConfig(),
                              is_specular=(False, True)[:len(slots)])
    bundle, ch = poisson_kernel.pack_bundle(texs, gb, slots)
    got = poisson_kernel._launch(bundle, ch, slots, 11, cfg, row0, (hg, w))
    want = poisson_kernel.poisson_pass_plain(bundle, ch, slots, 11, cfg, row0,
                                             (hg, w))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5)
    unsharded = poisson_kernel.poisson_pass_plain(bundle, ch, slots, 11, cfg)
    assert float((want - unsharded).abs().max()) > 1e-3


def _poisson_args(slots):
    """(bundle, slot channels, slots, noise index, config) of a 48 x 80
    frame with ``slots``' textures."""
    h, w = 48, 80
    rng = np.random.default_rng(2)
    depth, nrm = _surface(h, w, 3)
    z = torch.zeros
    gb = GBuffer(diffuse=z(h, w, 4), normal=nrm,
                 roughness=torch.tensor(rng.random((h, w)), dtype=torch.float32),
                 metalness=z(h, w), emissive=z(h, w, 3), depth=depth)
    texs = [torch.tensor(np.concatenate(
        [rng.random((h, w, 3)) * 2, rng.integers(0, 40, (h, w, 1))], -1),
        dtype=torch.float32) for _ in slots]
    if slots == (True,):
        texs = [texs[0][..., [0, 0, 0, 3]]]
    cfg = dataclasses.replace(PoissonDenoiseConfig(),
                              is_specular=(False, True)[:len(slots)])
    bundle, ch = poisson_kernel.pack_bundle(texs, gb, slots)
    return bundle, ch, slots, 11, cfg


@pytest.mark.parametrize("slots", [(False, False), (True,)])
def test_poisson_source(host_kernels, slots):
    bundle, ch, slots, _, cfg = _poisson_args(slots)
    got = poisson_kernel._launch(bundle, ch, slots, 11, cfg)
    want = poisson_kernel.poisson_pass_plain(bundle, ch, slots, 11, cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("radius", [3.0, 12.0])
@pytest.mark.parametrize("slots,spec", [
    ((False, True, False), (True, False, True)),
    ((True, False, False, True), (False, True, True, False))])
def test_poisson_source_staged(host_kernels, slots, spec, radius):
    """3 and 4 slots, scalar and specular mixed, on a 45 x 83 frame whose
    32 x 8 tiles the edge cuts. At radius 3 every tap lands in the
    staged tile and halo; at radius 12 the reach (about 22 columns and 12
    rows) passes the staged halo, and those taps decode the bundle
    directly."""
    h, w = 45, 83
    rng = np.random.default_rng(len(slots) + int(radius))
    depth, nrm = _surface(h, w, 5)
    z = torch.zeros
    gb = GBuffer(diffuse=z(h, w, 4), normal=nrm,
                 roughness=torch.tensor(rng.random((h, w)) * 0.4, dtype=torch.float32),
                 metalness=z(h, w), emissive=z(h, w, 3), depth=depth)
    texs = []
    for scalar in slots:
        t = np.concatenate([rng.random((h, w, 3)) * 3 - 0.2,
                            rng.integers(0, 40, (h, w, 1))], -1)
        texs.append(torch.tensor(t[..., [0, 0, 0, 3]] if scalar else t,
                                 dtype=torch.float32))
    cfg = dataclasses.replace(PoissonDenoiseConfig(), radius=radius,
                              is_specular=spec)
    bundle, ch = poisson_kernel.pack_bundle(texs, gb, slots)
    got = poisson_kernel._launch(bundle, ch, slots, 7, cfg)
    want = poisson_kernel.poisson_pass_plain(bundle, ch, slots, 7, cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5)


def _sweep_args(miss_gi, dirs=16, steps=32, short_ends=False, n_rays=2):
    """The march's arguments over a real frame's rays (the analytic scene
    with the sphere, ``n_rays`` random ray sets, stochastic bins), with a
    NaN bin planted, and for two rays an out-of-range bin.
    ``short_ends`` (two rays): the rays of a third of the pixels end at a
    screen distance s_end in [0, 30) pixels, and one at NaN."""
    h, w = 36, 64
    cam = PerspectiveCamera(50, w / h, 0.1, 100)
    gb = analytic.frames_at(cam, [3], h, w, "cpu", sphere=True)[0][0]
    m = cam.matrices()
    view_pos = math3d.get_view_position(
        math3d.uv_grid(h, w), math3d.depth_to_view_z(gb.depth, m),
        m.projection_matrix, m.projection_matrix_inverse)
    rng = np.random.default_rng(4)
    rays = []
    for _ in range(n_rays):
        r = rng.normal(size=(h, w, 3))
        r[..., 2] = -np.abs(r[..., 2]) * 0.3 - 0.05
        rays.append(torch.tensor(r / np.linalg.norm(r, axis=-1, keepdims=True),
                                 dtype=torch.float32))
    noise = torch.tensor(rng.random((h, w)), dtype=torch.float32)
    z_tex, planes, table, radii_prev, _ = ssgi_sweep.march_inputs(
        view_pos, rays, gb.depth, m, 5, 10.0, dirs, steps, bin_noise=noise)
    planes[5, 3, 7] = float("nan")
    if n_rays == 2:
        planes[11, 4, 9] = float(dirs)
    if short_ends:
        for plane in (6, 12):
            cut = torch.tensor(rng.random((h, w)) < 1 / 3)
            ends = torch.tensor(rng.uniform(0, 30, (h, w)), dtype=torch.float32)
            planes[plane] = torch.where(cut, ends, planes[plane])
        planes[6, 20, 30] = float("nan")
    rad = torch.tensor(rng.uniform(0, 3, (h, w, 4)), dtype=torch.float16)
    return (z_tex, rad, planes, table, radii_prev, 10.0, 10.0, n_rays, dirs, steps,
            miss_gi)


def _sweep_case(miss_gi, dirs=16, steps=32, short_ends=False):
    """The march of :func:`_sweep_args`' two rays through the kernel's
    source and the plain version."""
    args = _sweep_args(miss_gi, dirs, steps, short_ends)
    got = sweep_kernel._launch(*args)
    want = sweep_kernel.sweep_march_plain(*args)
    assert any(bool(hit.any()) for hit, *_ in want)
    for g, wnt in zip(got, want):
        for a, b in zip(g, wnt):
            assert torch.equal(a, b)


@pytest.mark.parametrize("miss_gi", [False, True])
def test_sweep_source(host_kernels, miss_gi):
    """The flagship's 16 x 32 table."""
    _sweep_case(miss_gi)


@pytest.mark.parametrize("miss_gi", [False, True])
def test_sweep_source_short_ends(host_kernels, miss_gi):
    """Rays that end on the screen (s_end) before the table does."""
    _sweep_case(miss_gi, short_ends=True)


@pytest.mark.parametrize("dirs,steps,miss_gi", [
    (32, 128, False), (32, 128, True), (64, 304, True)])
def test_sweep_source_large_table(host_kernels, dirs, steps, miss_gi):
    """A 32 x 128 table (12,416 floats as (dy, dx, s) + radii, 66 KB as
    the kernel packs it: over 48 KB, through the shared-memory opt-in)
    and a 64 x 304 one (312 KB packed, over the card's 227 KB opt-in
    limit: read from device memory)."""
    packed = sweep_kernel.packed_table(
        *ssgi_sweep.step_table(5, 36, 64, dirs, steps, 1.5)[:2], dirs, steps)
    assert (packed.nbytes > 48 * 1024) and ((packed.nbytes > 232448) == (dirs == 64))
    _sweep_case(miss_gi, dirs, steps)


def _flagship_table(h, w, eye, target, face_keep=False):
    """The z-scan table of the flagship scene seen from ``eye``."""
    scene = analytic.flagship_scene("cpu")
    packed = scene.pack("cpu")
    cam = PerspectiveCamera(50, w / h, 0.1, 100)
    cam.set_position(*eye)
    cam.look_at(target)
    world, _ = rasterizer._world_transform(
        packed, torch.tensor(scene.model_matrices()))
    clip = rasterizer._clip_positions(world, cam.matrices().projection_view_matrix)
    captured = []
    real = raster_kernel.zscan
    keep = (packed.face_mesh != 1) if face_keep else None
    raster_kernel.zscan = lambda tab, hh, ww: captured.append(tab) or real(tab, hh, ww)
    try:
        rasterizer._visibility(clip, packed.faces, h, w, keep)
    finally:
        raster_kernel.zscan = real
    return captured[0]


@pytest.mark.parametrize("view", ["orbit", "inside", "face_keep"])
def test_zscan_source(host_kernels, view):
    """The z-scan over the flagship scene at 45 x 83 (blocks cut by the
    frame edge), from the orbit, from inside the geometry (triangles
    crossing w = 0, unbounded bboxes) and with the box's faces dropped."""
    h, w = 45, 83
    eye, target = ((3.0, 2.5, 4.0), (0, 0.5, 0))
    if view == "inside":
        eye, target = (0.2, 0.4, 0.2), (2, 0.5, 1)
    tab = _flagship_table(h, w, eye, target, face_keep=view == "face_keep")
    got = raster_kernel._launch(tab, h, w)
    want = raster_kernel.zscan_plain(tab, h, w)
    assert bool((want[0] >= 0).any()) and bool((want[0] < 0).any() or view == "inside")
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def _synthetic_table(case, h, w):
    """A z-scan table of random screen-space triangles at (h, w), each
    case over three block-widths (768) of triangles: ``many`` scattered
    triangles of mixed size, winding and w; ``ties`` 420 triangles and
    a scrambled duplicate of each (equal planes, so a tie that the lowest
    id must win); ``scrambled`` large overlapping triangles whose depth
    order is a shuffle of their id order; ``overflow`` 700 small
    triangles inside one 16 x 16 tile, more than a round of the kernel
    holds (256), among 200 scattered ones; ``triples`` 280 triangles and
    two scrambled duplicates of each, so that the alpha variant's peel
    planes 3 and 4 (either side of its first chunk) tie."""
    rng = np.random.default_rng(
        ["many", "ties", "scrambled", "overflow", "triples"].index(case))

    def scatter(n, lo, hi, size):
        centre = rng.uniform(lo, hi, (n, 1, 2))
        return centre + rng.normal(size=(n, 3, 2)) * size[:, None, None]

    if case == "many":
        verts = scatter(900, (-5, -5), (w + 5, h + 5), rng.uniform(0.5, 12, 900))
    elif case == "ties":
        verts = scatter(420, (0, 0), (w, h), rng.uniform(2, 15, 420))
    elif case == "triples":
        verts = scatter(280, (0, 0), (w, h), rng.uniform(3, 18, 280))
    elif case == "scrambled":
        verts = scatter(800, (0, 0), (w, h), rng.uniform(10, 40, 800))
    else:
        verts = np.concatenate([
            scatter(700, (18, 18), (30, 30), rng.uniform(0.5, 2, 700)),
            scatter(200, (0, 0), (w, h), rng.uniform(1, 10, 200))])
    n = verts.shape[0]
    tri_w = rng.uniform(0.5, 2.0, (n, 3))
    if case == "scrambled":   # flat triangles, depth order shuffled
        tri_w[:] = 1.0
        tri_z = np.repeat(rng.permutation(np.linspace(-0.9, 0.9, n))[:, None], 3, 1)
    else:
        tri_z = rng.uniform(-0.95, 0.95, (n, 3)) * tri_w
    x, y = verts[..., 0], verts[..., 1]
    nxt, nxt2 = [1, 2, 0], [2, 0, 1]
    a = y[:, nxt] - y[:, nxt2]
    b = x[:, nxt2] - x[:, nxt]
    c = x[:, nxt] * y[:, nxt2] - x[:, nxt2] * y[:, nxt]
    coeffs = np.stack([a, b, c], -1)            # (F, 3 edges, A B C)
    sgn = np.where(c.sum(1) >= 0, 1.0, -1.0)
    bbox = np.stack([x.min(1), x.max(1), y.min(1), y.max(1)], -1)
    valid = rng.random(n) > 0.02
    t = lambda v, dt=torch.float32: torch.tensor(v, dtype=dt)
    tab = raster_kernel.zscan_table(t(coeffs), t(tri_z), t(tri_w), t(sgn),
                                    t(valid, torch.bool), t(bbox))
    if case == "ties":
        tab = torch.cat([tab, tab[torch.tensor(rng.permutation(n))]])
    elif case == "triples":
        tab = torch.cat([tab] + [tab[torch.tensor(rng.permutation(n))] for _ in range(2)])
    return tab


@pytest.mark.parametrize("case", ["many", "ties", "scrambled", "overflow", "triples"])
def test_zscan_source_binning(host_kernels, case):
    """The per-block binning on synthetic tables at 45 x 83, bit for bit:
    ties to the lowest id, overlaps out of id order, a tile whose list
    takes several rounds."""
    h, w = 45, 83
    tab = _synthetic_table(case, h, w)
    got = raster_kernel._launch(tab, h, w)
    want = raster_kernel.zscan_plain(tab, h, w)
    ids = want[0]
    assert tab.shape[0] > 3 * 256 and bool((ids >= 0).float().mean() > 0.3)
    if case in ("ties", "triples"):   # the winners are the first copies
        first = tab.shape[0] // (2 if case == "ties" else 3)
        assert bool((ids[ids >= 0] < first).all())
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("case,cnmf,passes", [
    ("flagship", 0.0, 3), ("flagship", 3.0, 3), ("many", 20.0, 2),
    ("ties", 3.0, 3), ("scrambled", 0.0, 2), ("overflow", 20.0, 3),
    ("many", 3.0, 1), ("ties", 0.0, 5), ("scrambled", 20.0, 6),
    ("flagship", 20.0, 9), ("triples", 3.0, 6)])
def test_zscan_alpha_source(host_kernels, case, cnmf, passes):
    """The z-scan's alpha variant, every depth-peel pass in one launch,
    against ``passes`` passes of the plain version, bit for bit, each
    pass excluding the earlier passes' winners: material alpha drawn
    from 1, 0.9999, 0.7, 0.5, 0.3 and 0.1 (opaque, the opaque cut, both
    sides of the hard cut), a dither of uniform noise (a strided view),
    and cnmf 0 (the hard cut), 3 and 20 (the soft law, ``fmaf`` in the kernel and the
    float64 fma of ``core.math3d.fma`` in the plain version). One pass;
    passes above the kernel's four register planes (5, 6, 9) run as
    chunks, each after the floor of the one before (on the triples, a
    floor that ties the next chunk's first winners). On the tie-heavy
    table the second pass must hand each pixel its excluded winner's
    duplicate: exclusion is by id."""
    h, w = 45, 83
    if case == "flagship":
        tab = _flagship_table(h, w, (3.0, 2.5, 4.0), (0, 0.5, 0))
    else:
        tab = _synthetic_table(case, h, w)
    rng = np.random.default_rng(int(cnmf) + passes)
    n = tab.shape[0]
    # drawn from the row's bits, so a triangle and its duplicate share it
    pick = tab.contiguous().view(torch.int32)[:, :9].sum(1).remainder(6)
    alpha = torch.tensor([1.0, 0.9999, 0.7, 0.5, 0.3, 0.1])[pick]
    # a channel of a wider array, as the composer's dither: read through
    # its strides
    dither = torch.zeros((h, w + 5, 2))[:, :w, 1]
    dither.copy_(torch.tensor(rng.random((h, w)), dtype=torch.float32))
    got_ids, got_z = raster_kernel._launch_peels(tab, h, w, alpha, dither, cnmf, passes)
    assert got_ids.shape == got_z.shape == (passes, h, w)
    exclude = []
    for p in range(passes):
        want = raster_kernel.zscan_plain(tab, h, w, alpha, dither, cnmf,
                                         torch.stack(exclude) if exclude else None)
        assert bool((want[0] >= 0).any()) or p >= 3
        assert torch.equal(got_ids[p], want[0])
        assert torch.equal(got_z[p], want[1])
        for prev in exclude:
            assert not bool(((want[0] == prev) & (prev >= 0)).any())
        if case == "ties" and p == 1:
            won = want[0][want[0] >= 0]
            assert bool((won >= n // 2).float().mean() > 0.5)
        exclude.append(want[0])


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("k", [1, 11, 24, 30, 33])
def test_lookup_source(host_kernels, k, offset):
    """Record widths through the generic instantiation (1, 11), the
    16-byte route (24) and the scalar-load route (30, 33); ids negative and
    past the last row; a 37 x 61 frame, whose last block of 256 pixels
    is filled in part; ``offset`` 1: a table that is a view 4 bytes into
    its storage, so not 16-byte aligned."""
    rng = np.random.default_rng(6 + k)
    vals = torch.tensor(rng.normal(size=(3, 128, k)), dtype=torch.float32)
    table = torch.empty(vals.numel() + offset)[offset:].view(3, 128, k).copy_(vals)
    assert (table.data_ptr() % 16 == 0) == (offset == 0)
    ids = torch.tensor(rng.integers(-3, 3 * 128 + 40, (37, 61)), dtype=torch.int32)
    ids[0, :3] = torch.tensor([-(1 << 31), (1 << 31) - 1, 3 * 128])
    got = table_kernel._launch(table, ids)
    assert torch.equal(got, table_kernel.face_lookup_plain(table, ids))


def _blur_inputs(h, w, seed):
    """HDR colour (up to 4) and a velocity field: small motion, fast
    segments whose cells reach out of the frame on the left and at the
    top, and a static block."""
    rng = np.random.default_rng(seed)
    color = rng.uniform(0.0, 4.0, (h, w, 3))
    vel = rng.normal(0.0, 0.02, (h, w, 2))
    vel[:, :8] = (-0.4, 0.1)
    vel[-6:, :, 1] = 0.5
    vel[20:30, 40:60] = 0.0
    return (torch.tensor(color, dtype=torch.float32),
            torch.tensor(vel, dtype=torch.float32))


@pytest.mark.parametrize("dirs,steps,rows", [
    pytest.param(16, 12, None, id="frame"),
    pytest.param(16, 12, (20, 44), id="row-block"),
    pytest.param(1, 12, None, id="one-bin"),
    pytest.param(24, 12, None, id="two-launches"),
    pytest.param(7, 5, (8, 30), id="odd-row-block")])
def test_motion_blur_source(host_kernels, monkeypatch, dirs, steps, rows):
    """The accumulate pass of ``motion_blur_sweep`` on a 48 x 80 frame:
    the kernel's sums and the image resolved from them equal the plain
    loop's bit for bit (PyTorch's CPU ``addcmul_`` is a fused
    multiply-add, as the kernel's ``fmaf``). ``rows``: a row block at a
    row offset, reading the whole frame's colour; one bin: the two sides
    share every cell; 24 x 12 cells: two launches, the sums carried."""
    color, vel = _blur_inputs(48, 80, dirs * steps)
    kw = dict(dirs=dirs, steps=steps)
    if rows is not None:
        kw.update(row_offset=rows[0], source=color)
        color, vel = color[rows[0]:rows[1]], vel[rows[0]:rows[1]]
    sums = []

    def kernel_and_plain(*args):
        sums.append((motion_blur._launch(*args), motion_blur.accumulate_plain(*args)))
        assert torch.equal(args[3], args[4]) == (dirs == 1)   # bin_pos, bin_neg
        return sums[-1][0]

    monkeypatch.setattr(motion_blur, "accumulate", kernel_and_plain)
    got = motion_blur.motion_blur_sweep(color, vel, 3, **kw)
    monkeypatch.setattr(motion_blur, "accumulate", motion_blur.accumulate_plain)
    want = motion_blur.motion_blur_sweep(color, vel, 3, **kw)
    (acc_k, acc_p), = sums
    assert torch.equal(acc_k, acc_p)
    assert float(acc_p[..., 3].min()) == 0.0 and float(acc_p[..., 3].max()) > 5.0
    assert torch.equal(got, want)
    assert float((got - color).abs().max()) > 0.1


def _taps_inputs(h, w, seed, case):
    """HDR colour and a velocity field for the taps: ``frame``, the
    accumulate pass's (fast segments out of the frame on the left and at
    the top, a static block); ``edges``, segments up to a frame long in
    every direction, so taps land past all four edges; ``still``, no
    motion anywhere."""
    color, vel = _blur_inputs(h, w, seed)
    if case == "edges":
        rng = np.random.default_rng(seed + 1)
        vel = torch.tensor(rng.uniform(-1.0, 1.0, (h, w, 2)), dtype=torch.float32)
    elif case == "still":
        vel = torch.zeros_like(vel)
    return color, vel


@pytest.mark.parametrize("case,rows,options", [
    pytest.param("frame", None, {}, id="frame"),
    pytest.param("frame", (20, 44), {}, id="row-block"),
    pytest.param("edges", None, {}, id="past-every-edge"),
    pytest.param("edges", (8, 30), dict(intensity=0.7, jitter=0.5, delta_time=1 / 30,
                                        samples=5), id="row-block-options"),
    pytest.param("still", None, {}, id="still")])
def test_motion_blur_taps_source(host_kernels, case, rows, options):
    """``motion_blur``'s taps on a 48 x 80 frame: the kernel's image
    equals the plain route's bit for bit. ``rows``: a row block at a row
    offset reading the whole frame's colour; a still frame returns its
    colour."""
    color, vel = _taps_inputs(48, 80, 5, case)
    kw = dict(dict(intensity=1.0, jitter=1.0, delta_time=1 / 60, samples=16), **options)
    args = dict(kw, row_offset=0, source=None)
    if rows is not None:
        args.update(row_offset=rows[0], source=color)
        color, vel = color[rows[0]:rows[1]], vel[rows[0]:rows[1]]
    got = motion_blur._launch_taps(color, vel, 7, **args)
    want = motion_blur.motion_blur_plain(color, vel, 7, **args)
    assert torch.equal(got, want)
    moved = float((got - color).abs().max())
    assert moved == 0.0 if case == "still" else moved > 0.1


def _march_args(kind, mode, refine_steps, rows, thickness):
    """The rays ``ops.ssgi._setup`` draws on the analytic scene at 40 x
    64 (SSGI's two, SSR's one; env off) with its strided random plane:
    the configuration and per ray the march's arguments. ``rows``: the
    lanes of a row block marching against the whole frame's depth."""
    h, w = 40, 64
    cam = (OrthographicCamera(-2.0 * w / h, 2.0 * w / h, 2.0, -2.0, 0.1, 100)
           if kind == "ortho" else PerspectiveCamera(50, w / h, 0.1, 100))
    gb = analytic.frames_at(cam, [3], h, w, "cpu", sphere=True)[0][0]
    m = cam.matrices()
    cfg = ssgi.SSGIConfig(mode=mode, trace="march", refine_steps=refine_steps)
    r0, r1 = rows or (0, h)
    block = GBuffer(**{f.name: getattr(gb, f.name)[r0:r1]
                       for f in dataclasses.fields(gb) if getattr(gb, f.name) is not None})
    p = ssgi._setup(block, None, m, 3, cfg, r0, h)
    assert p["r3"].stride(-1) == 4 and len(p["rays"]) == (2 if mode == "ssgi" else 1)
    return cfg, [(p["view_pos"], ray, gb.depth, m, p["r3"], thickness, 10.0)
                 for ray in p["rays"]]


def _march_case(kind, mode, refine_steps, rows, thickness):
    """Per ray of :func:`_march_args` the (kernel, plain) results."""
    cfg, rays = _march_args(kind, mode, refine_steps, rows, thickness)
    out = []
    for args in rays:
        got = march_kernel.launch(*args, cfg.steps, cfg.refine_steps)
        want = ssgi.view_space_ray_march_plain(*args, cfg)
        out.append((got, want))
    return out


@pytest.fixture
def glibc_exp(monkeypatch):
    """``torch.exp`` through the C library's ``expf``, the one the host
    build of the sources calls."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.expf.restype = ctypes.c_float
    libm.expf.argtypes = [ctypes.c_float]

    def exp(t):
        a = t.numpy()
        return torch.from_numpy(np.array([libm.expf(float(v)) for v in a.reshape(-1)],
                                         np.float32).reshape(a.shape))
    monkeypatch.setattr(torch, "exp", exp)


#: with PyTorch's ``exp`` against glibc's (module docstring): the share of
#: lanes whose hit may differ, and the mean gap of the others' uv and
#: hit position (measured on the SSGI case: no flip, mean gaps up to
#: 2.0e-10, the largest 1.9e-6)
MARCH_FLIP_FRAC = 0.01
MARCH_MEAN_TOL = 1e-7


@pytest.mark.parametrize("kind,mode,refine_steps,rows,thickness", [
    pytest.param("persp", "ssgi", 5, None, 10.0, id="ssgi"),
    pytest.param("persp", "ssgi", 0, None, 10.0, id="ssgi-unrefined"),
    pytest.param("ortho", "ssr", 5, None, 10.0, id="ssr-ortho"),
    pytest.param("ortho", "ssr", 0, None, 10.0, id="ssr-ortho-unrefined"),
    pytest.param("persp", "ssgi", 5, (12, 28), 10.0, id="row-block"),
    pytest.param("persp", "ssr", 5, None, 0.0625, id="thin")])
def test_ray_march_source(host_kernels, glibc_exp, kind, mode, refine_steps, rows,
                          thickness):
    """The march of each ray equals the plain route's bit for bit, both
    with the same ``expf``: uv, hit position and the miss flag, over
    lanes that hit and lanes that miss. ``thin``: a thickness of 1/16, so
    most hits are decided at the edge of a depth texel's span."""
    for got, want in _march_case(kind, mode, refine_steps, rows, thickness):
        missed = want[2]
        assert 0.0 < float(missed.float().mean()) < 1.0
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_ray_march_source_against_aten_exp(host_kernels):
    """With PyTorch's own ``exp`` in the plain route: at most
    MARCH_FLIP_FRAC of lanes differ in their hit, the others agree to
    MARCH_MEAN_TOL on average."""
    for got, want in _march_case("persp", "ssgi", 5, None, 10.0):
        flip = got[2] != want[2]
        assert float(flip.float().mean()) <= MARCH_FLIP_FRAC
        keep = ~flip & ~want[2]
        for a, b in zip(got[:2], want[:2]):
            assert float((a - b).abs()[keep].mean()) <= MARCH_MEAN_TOL


@pytest.mark.parametrize("name,entry", [
    ("raster", "re_zscan"), ("raster", "re_zscan_peels"), ("table", "re_lookup"),
    ("taps", "re_poisson_taps"),
    ("hbao", "re_hbao_noise"),
    ("stencil", "re_sharpness"), ("warp", "re_warp_multi"),
    ("sweep", "re_ray_march"), ("motion_blur", "re_motion_blur_taps"),
    ("reproject", "re_reproject"), ("shade", "re_shade")])
def test_raster_sources_are_listed(name, entry):
    """The kernels of the raster slice, the demo stack, the unfused route,
    HBAO's noise table and the reprojection are built with the others and
    declare their C entry points for ctypes."""
    assert name in cuda_build.SOURCES
    src = (cuda_build.CSRC / f"{name}.cu").read_text()
    assert re.search(rf'extern "C" int {entry}\(', src)
    assert "__global__" in src


@pytest.fixture
def glibc_libm(monkeypatch):
    """``torch.log``, ``torch.exp`` and a tensor's ``**`` by a host
    scalar through the C library's ``logf``, ``expf`` and ``powf``, the
    ones the host build of the sources calls (the powers ATen takes
    otherwise, 0, 1, 0.5, 2 and 3, keep its own route), and
    ``torch.sqrt`` correctly rounded, as ``sqrtf`` and the card's
    ``sqrt`` are (PyTorch's vectorised CPU sqrt is not: 0.5001 ulp)."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    for name, n in (("logf", 1), ("expf", 1), ("powf", 2)):
        getattr(libm, name).restype = ctypes.c_float
        getattr(libm, name).argtypes = [ctypes.c_float] * n

    def elementwise(f, t, *args):
        a = t.numpy()
        return torch.from_numpy(np.array([f(float(v), *args) for v in a.reshape(-1)],
                                         np.float32).reshape(a.shape))

    pow_ = torch.Tensor.__pow__
    monkeypatch.setattr(torch, "log", lambda t: elementwise(libm.logf, t))
    monkeypatch.setattr(torch, "exp", lambda t: elementwise(libm.expf, t))
    monkeypatch.setattr(torch, "sqrt",
                        lambda t: torch.from_numpy(np.asarray(np.sqrt(t.numpy()))))
    monkeypatch.setattr(torch.Tensor, "__pow__", lambda t, e: (
        pow_(t, e) if float(e) in (0.0, 1.0, 0.5, 2.0, 3.0)
        else elementwise(libm.powf, t, float(e))))


REPROJECT_H, REPROJECT_W = 64, 96


def _reproject_buffers(seed):
    """A 64 x 96 frame's velocity buffers, inputs and history: small
    motion, motion beyond the +-8 row / +-30 column window and a
    background band; normals smooth on the right half (so hit points
    are valid there) and noisy on the left; inputs not sampled on a
    lattice; alphas that cross the roughness and ray-length thresholds;
    history with sample counts in alpha."""
    h, w = REPROJECT_H, REPROJECT_W
    rng = np.random.default_rng(seed)
    xx = np.arange(w)[None, :]
    vel = rng.normal(0.0, 0.01, (h, w, 2))
    vel[:, : w // 4, 0] = 40.0 / w
    vel[h // 2:, w // 2:, 1] = -12.0 / h
    depth = 0.9 + 0.05 * np.sin(xx * 0.1) + 0.01 * rng.random((h, w))
    depth[: h // 10] = 1.0
    nrm = np.array([0.0, 0.3, 0.95]) + rng.normal(0, 0.05, (h, w, 3))
    nrm[:, w // 2:] = np.array([0.0, 0.3, 0.95]) + 0.002 * np.sin(xx[..., None] * 0.3)[:, w // 2:]
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[: h // 10] = 0.0
    last_depth = np.clip(depth + rng.normal(0, 0.002, (h, w)), 0, 1)
    last_nrm = nrm + rng.normal(0, 0.02, (h, w, 3))

    def rgba(alpha):
        c = np.concatenate([rng.random((h, w, 3)) * 1.5, alpha[..., None]], -1)
        c[::5, ::7, 0] = -1.0
        return c

    def on_thresholds(a, values):   # some texels exactly at each threshold
        for k, v in enumerate(values):
            a[k::7, 2 * k::9] = v
        return a

    diffuse = rgba(on_thresholds(rng.uniform(-0.1, 1.2, (h, w)), (0.25, 0.1, 0.0)))
    specular = rgba(on_thresholds(rng.uniform(-0.05, 0.6, (h, w)), (0.01,)))  # ray length
    history = [np.concatenate([rng.random((h, w, 3)), rng.integers(0, 30, (h, w, 1))], -1)
               for _ in range(2)]
    roughness = on_thresholds(rng.uniform(-0.1, 1.2, (h, w)), (0.25, 0.1, 0.0))
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    from realism_effects_tpu_torch.core.framebuffers import VelocityBuffer
    return (VelocityBuffer(velocity=t(vel), normal=t(nrm), depth=t(depth)),
            VelocityBuffer(velocity=t(vel), normal=t(last_nrm), depth=t(last_depth)),
            t(diffuse), t(specular), [t(a) for a in history], t(roughness))


def _reproject_cams(ortho):
    h, w = REPROJECT_H, REPROJECT_W
    out = []
    for x in (0.5, 0.45):
        cam = (OrthographicCamera(-2.0 * w / h, 2.0 * w / h, 2.0, -2.0, 0.1, 100)
               if ortho else PerspectiveCamera(50, w / h, 0.1, 100))
        cam.set_position(x, 2.0, 4.0)
        cam.look_at((0, 0.5, 0))
        out.append(cam.matrices())
    return out


_TRAA = dict(texture_count=1, log_transform=True, confidence_power=4.0)
_SSGI = dict(texture_count=2, log_transform=True, reproject_specular=(False, True),
             confidence_power=0.75, input_type="diffuse_specular")
_SSR = dict(texture_count=1, log_transform=True, reproject_specular=(True,),
            confidence_power=0.75, input_type="specular")
_TRAA_CALL = dict(max_blend=0.9, neighborhood_clamp_intensity=1.0, full_accumulate=False)
_SSGI_CALL = dict(max_blend=1.0, neighborhood_clamp_intensity=0.5, full_accumulate=False)

#: (configuration, call, roughness texture, orthographic, row block);
#: ``-offset``: the inputs and history 4 bytes past a 16-byte boundary,
#: so read without 16-byte loads
REPROJECT_CASES = {
    "traa": (_TRAA, _TRAA_CALL, False, False, None),
    "ssgi": (_SSGI, _SSGI_CALL, False, False, None),
    "ssgi-full-accumulate": (_SSGI, dict(_SSGI_CALL, full_accumulate=True), False, False,
                             None),
    "ssr-roughness": (_SSR, _SSGI_CALL, True, False, None),
    "ssr": (_SSR, _SSGI_CALL, False, False, None),
    "ssgi-dilation": (dict(_SSGI, dilation=True), _SSGI_CALL, False, False, None),
    "traa-linear": (dict(_TRAA, log_transform=False), _TRAA_CALL, False, False, None),
    "ssgi-ortho": (_SSGI, _SSGI_CALL, False, True, None),
    "ssgi-row-block": (_SSGI, _SSGI_CALL, False, False, (40, 64)),
    "ssgi-offset": (_SSGI, _SSGI_CALL, False, False, None),
}
#: rows a row block that ends at the frame's last row carries past it
#: (the split frame's halo there); their values are any (the block's
#: first rows): no difference reaches across the frame's last row
REPROJECT_EDGE_ROWS = 3


def _reproject_case(name):
    """(kernel, plain) results of the case ``name``: the kernels' route of
    ``ops/reproject_kernel.py`` (the fetches taking their plain versions
    on the CPU) and ``temporal_reproject_plain``."""
    from realism_effects_tpu_torch.core.framebuffers import VelocityBuffer
    from realism_effects_tpu_torch.ops import reproject_kernel
    from realism_effects_tpu_torch.ops import temporal_reproject as tr

    kw, call, rough, ortho, rows = REPROJECT_CASES[name]
    cfg = tr.TemporalReprojectConfig(**kw)
    vel, last, diffuse, specular, history, roughness = _reproject_buffers(5)
    inputs = {"diffuse": [diffuse], "specular": [specular],
              "diffuse_specular": [diffuse, specular]}[cfg.input_type]
    history = history[:cfg.texture_count]
    cam, prev = _reproject_cams(ortho)
    args = dict(call, keep_data=1.0, roughness_tex=roughness if rough else None)
    if rows is not None:
        r0, r1 = rows
        edge = list(range(r0, r0 + (REPROJECT_EDGE_ROWS if r1 == REPROJECT_H else 0)))
        cut = lambda t: t[list(range(r0, r1)) + edge].contiguous()
        vel, last = (VelocityBuffer(velocity=cut(b.velocity), normal=cut(b.normal),
                                    depth=cut(b.depth)) for b in (vel, last))
        inputs, history = [cut(t) for t in inputs], [cut(t) for t in history]
        args.update(row_offset=r0, frame_height=REPROJECT_H)
    if name.endswith("-offset"):
        def offset(t):
            view = torch.empty(t.numel() + 1)[1:].view(t.shape).copy_(t)
            assert view.data_ptr() % 16 != 0
            return view
        inputs, history = [offset(t) for t in inputs], [offset(t) for t in history]
    got = reproject_kernel.reproject(inputs, history, vel, last, cam, prev, cfg, **args)
    want = tr.temporal_reproject_plain(inputs, history, vel, last, cam, prev, cfg, **args)
    return got, want


@pytest.mark.parametrize("case", list(REPROJECT_CASES))
def test_reproject_source(host_kernels, glibc_libm, case):
    """The reprojection's prepare and blend kernels, with the fetches
    between them, equal ``temporal_reproject_plain`` bit for bit, both
    with glibc's logf, expf and powf; each slot keeps history somewhere
    and resets it somewhere."""
    for got, want in zip(*_reproject_case(case), strict=True):
        assert torch.equal(got, want)
        alpha = want[..., 3]
        assert bool((alpha > 1.5).any()) and bool((alpha < 1e-3).any())


@pytest.mark.parametrize("case", list(REPROJECT_CASES))
def test_reproject_source_against_aten(host_kernels, case):
    """With PyTorch's own log, exp, pow and sqrt in the plain route, whose
    CPU versions differ from glibc's by ulps: colours within rtol 5e-5
    and atol 2e-5, the sample count compared as the blend weight
    t = a / (1 + a) it came from at the same tolerance, as the port's
    reprojection is held to the JAX package's (measured over these
    cases: colours at most 2.3e-5 apart, 6e-5 relative; t at most
    1.1e-5)."""
    for got, want in zip(*_reproject_case(case), strict=True):
        np.testing.assert_allclose(got[..., :3], want[..., :3], rtol=5e-5, atol=2e-5)
        blend = lambda a: a / (1.0 + a)
        np.testing.assert_allclose(blend(got[..., 3]), blend(want[..., 3]), rtol=5e-5,
                                   atol=2e-5)


SHADE_H, SHADE_W = 37, 61   # odd: the shared environment quads clamp at the frame's edge
SHADE_FRAME = 7             # the quads' fetched member (1, 1) at stride 2
SHADE_ROWS = (13, SHADE_H)  # a row block that ends at the frame's last row

#: (trace, SSGIConfig changes, row block): the sweep's and the march's
#: shade over the same frame; ``-row-block`` the rows of SHADE_ROWS with
#: the split frame's halo of ``env_fetch_stride - 1`` rows each side
SHADE_CASES = {
    "sweep": ("sweep", {}, False),
    "sweep-ssr": ("sweep", dict(mode="ssr"), False),
    "sweep-missed-rays": ("sweep", dict(missed_rays=True), False),
    "sweep-no-env": ("sweep", dict(importance_sampling=False), False),
    "sweep-env-box": ("sweep", dict(env_box=((6.0, 4.0, 5.0), (0.5, 1.0, -0.5))), False),
    "sweep-row-block": ("sweep", {}, True),
    "sweep-stride-1": ("sweep", dict(env_fetch_stride=1, env_lum_clamp=False,
                                     use_direct_light=False), False),
    "march": ("march", {}, False),
    "march-ssr": ("march", dict(mode="ssr"), False),
    "march-missed-rays": ("march", dict(missed_rays=True), False),
    "march-no-env": ("march", dict(importance_sampling=False), False),
    "march-env-box": ("march", dict(env_box=((6.0, 4.0, 5.0), (0.5, 1.0, -0.5))), False),
    "march-row-block": ("march", {}, True),
}


def _shade_inputs(case):
    """The arguments of ``ops.ssgi._shade`` in the case ``case``: the
    analytic scene (sphere, box, plane) at SHADE_H x SHADE_W under the
    procedural sky, roughness scaled down a ramp so that some pixels
    pass under the 0.15 of the environment's mip scale, last frame's
    output random, the traces of ``_setup``'s rays (the sweep's with
    the prewarped radiance). ``-no-env``: no environment (nor its
    importance sampling)."""
    from realism_effects_tpu_torch.core.envmap import build_equirect_env, procedural_sky

    trace, changes, block = SHADE_CASES[case]
    h, w = SHADE_H, SHADE_W
    cam = PerspectiveCamera(50, w / h, 0.1, 100)
    gb, vel, color = analytic.frames_at(cam, [3], h, w, "cpu", sphere=True)[0]
    ramp = torch.linspace(0.1, 1.0, w)[None, :].expand(h, w)
    gb = gb.replace(roughness=gb.roughness * ramp)
    m = cam.matrices()
    env = (None if case.endswith("-no-env")
           else build_equirect_env(procedural_sky(64, 128), device="cpu"))
    cfg = ssgi.SSGIConfig(trace=trace, **changes)
    acc = torch.rand((h, w, 4), generator=torch.Generator().manual_seed(1)) * 2.0
    p = ssgi._setup(gb, env, m, SHADE_FRAME, cfg)
    if trace == "sweep":
        traces = ssgi_sweep.sweep_ray_march(
            p["view_pos"], p["rays"], gb.depth, m, SHADE_FRAME, 10.0, 10.0,
            bin_noise=ssgi._bin_noise(p, SHADE_FRAME),
            radiance=ssgi._prewarp(acc, vel, p["uv"]), miss_radiance=cfg.missed_rays)
    else:
        traces = [ssgi.view_space_ray_march_plain(p["view_pos"], ray, gb.depth, m, p["r3"],
                                                  10.0, 10.0, cfg) for ray in p["rays"]]
    if block:
        halo = cfg.env_fetch_stride - 1
        r0, r1 = SHADE_ROWS
        idx = torch.arange(r0 - halo, r1 + halo).clamp(0, h - 1)
        gb = GBuffer(**{f.name: getattr(gb, f.name)[idx]
                        for f in dataclasses.fields(gb) if getattr(gb, f.name) is not None})
        p = ssgi._setup(gb, env, m, SHADE_FRAME, cfg, r0 - halo, h)
        traces = [tuple(t[idx] for t in tr) for tr in traces]
        color = color[idx]
    vel_tex, acc_tex = (None, None) if trace == "sweep" else (vel.velocity, acc)
    return p, traces, vel_tex, acc_tex, color, env, m, SHADE_FRAME, cfg, 0.5


def _shade_case(case, plain=None):
    """(kernel, plain) results of the case ``case``: ``ops/shade_kernel.py``
    and ``_shade_plain``, the latter inside ``plain`` (a context) where
    given; one torch thread (the frame's few thousand pixels run ten
    times slower split over a loaded machine's threads)."""
    import contextlib

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        args = _shade_inputs(case)
        got = shade_kernel.shade(*args)
        with plain or contextlib.nullcontext():
            want = ssgi._shade_plain(*args)
    finally:
        torch.set_num_threads(n)
    return got, want, args


@pytest.fixture
def glibc_shade(monkeypatch):
    """A context in which ``torch.atan2``, ``torch.acos``, ``torch.sqrt``
    and a tensor's ``**`` by a host scalar go through the C library's
    ``atan2f``, ``acosf``, ``sqrtf`` and ``powf``, the ones the host build
    of the sources calls (the powers ATen takes otherwise keep its own
    route, as in ``glibc_libm``)."""
    import contextlib

    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    for name, n in (("atan2f", 2), ("acosf", 1), ("powf", 2), ("sqrtf", 1)):
        getattr(libm, name).restype = ctypes.c_float
        getattr(libm, name).argtypes = [ctypes.c_float] * n

    def elementwise(f, *ts, args=()):
        ts = torch.broadcast_tensors(*ts)
        flat = [t.contiguous().numpy().reshape(-1) for t in ts]
        out = np.array([f(*(float(a[k]) for a in flat), *args) for k in range(flat[0].size)],
                       np.float32)
        return torch.from_numpy(out.reshape(ts[0].shape))

    pow_ = torch.Tensor.__pow__

    @contextlib.contextmanager
    def patch():
        with monkeypatch.context() as mp:
            mp.setattr(torch, "atan2", lambda a, b: elementwise(libm.atan2f, a, b))
            mp.setattr(torch, "acos", lambda t: elementwise(libm.acosf, t))
            mp.setattr(torch, "sqrt", lambda t: elementwise(libm.sqrtf, t))
            mp.setattr(torch.Tensor, "__pow__", lambda t, e: (
                pow_(t, e) if float(e) in (0.0, 1.0, 0.5, 2.0, 3.0)
                else elementwise(libm.powf, t, args=(float(e),))))
            yield
    return patch


#: with PyTorch's own atan2, acos, sqrt and pow in the plain route: the
#: gap allowed (measured over SHADE_CASES: at most 9.5e-7, 1.1e-6
#: relative; an ulp of atan2 or acos could move an environment fetch to
#: the next texel, which these inputs do not)
SHADE_ATEN_RTOL, SHADE_ATEN_ATOL = 1e-5, 2e-5


@pytest.mark.parametrize("libm", ["glibc", "aten"])
@pytest.mark.parametrize("case", list(SHADE_CASES))
def test_shade_source(host_kernels, glibc_shade, case, libm):
    """The shade kernel equals ``_shade_plain`` bit for bit, both with
    glibc's atan2f, acosf, sqrtf and powf (``glibc``), or within
    SHADE_ATEN_RTOL / SHADE_ATEN_ATOL of it with PyTorch's own in the
    plain route (``aten``); over background pixels, hits and misses,
    diffuse and specular samples, environment samples and (the sweep)
    radiance valid and not; the diffuse output's -1 mark where no
    diffuse sample was taken."""
    got, want, args = _shade_case(case, glibc_shade() if libm == "glibc" else None)
    for g, w_ in zip(got, want, strict=True):
        if libm == "glibc":
            assert torch.equal(g, w_)
        else:
            np.testing.assert_allclose(g, w_, rtol=SHADE_ATEN_RTOL, atol=SHADE_ATEN_ATOL)
    p, traces, cfg = args[0], args[1], args[8]
    fg = p["depth"] < 1.0
    assert bool((~fg).any()) and bool(fg.any())
    for tr in traces:
        missed = tr[2][fg]
        assert bool(missed.any()) and bool((~missed).any())
    if args[5] is not None:
        assert bool(p["is_env_sample"][fg].any())
    ids = p["is_diffuse_sample"][fg]
    marked = (want[0][..., :3] == -1.0).all(-1)[fg]
    if cfg.mode == "ssgi":
        assert bool(ids.any()) and torch.equal(marked, ~ids)
    else:
        assert bool(marked.all())

def _census_calls(module, monkeypatch):
    """The host-built launches of the ``ops`` module ``module``: (call,
    the census it leaves), a launch a call but where the census says
    otherwise."""
    if module == "warp":
        tex, ty, tx, fy, fx = _warp_inputs(4, near=True)
        return [(lambda m=m: warp._launch(tex, ty, tx, fy, fx, 8, m, None),
                 {f"warp_{m}": 1}) for m in ("nearest", "bilinear", "catrom", "catrom5")] + [
            (lambda: warp._launch_multi(tex, torch.stack([ty, ty]), torch.stack([tx, tx]),
                                        5, None), {"warp_multi": 1})]
    if module == "stencil":
        tex = _warp_inputs(4)[0]
        return [(lambda: stencil._launch(tex, 1), {"minmax": 1}),
                (lambda: stencil._launch_sharpness(tex.abs(), 1.0), {"sharpness": 1})]
    if module == "hbao_kernel":
        depth, nrm = _surface(48, 80, 1)
        cam = PerspectiveCamera(50, 80 / 48, 0.1, 80)
        cam.set_position(0.3, 1.5, 5.0)
        cam.look_at((0, 0.5, 0))
        m, cfg = cam.matrices(), AOConfig(distance=0.3)
        hbao_kernel._noise_table.cache_clear()
        run = lambda: hbao_kernel._launch(depth, nrm, m, 3, cfg)
        # the first launch of a setting builds its noise table, once
        return [(run, {"hbao_noise": 1, "hbao": 1}), (run, {"hbao": 1})]
    if module == "poisson_kernel":
        return [(lambda a=_poisson_args(slots): poisson_kernel._launch(*a), {key: 1})
                for slots, key in (((True,), "poisson"), ((False, False), "poisson_2tex"),
                                   ((False,), "poisson_1tex"))]
    if module == "poisson_taps":
        rng = np.random.default_rng(0)
        bundle = torch.tensor(rng.normal(size=(37, 61, 4)), dtype=torch.float32)
        iy, ix = _tap_targets(37, 61, 8, 3, rng)
        return [(lambda: poisson_taps._launch(bundle, iy, ix), {"poisson_taps": 1})]
    if module == "sweep_kernel":
        return [(lambda n=n: sweep_kernel._launch(*_sweep_args(False, 8, 12, n_rays=n)),
                 {key: 1}) for n, key in ((2, "sweep"), (1, "sweep_1ray"))]
    if module == "raster_kernel":
        tab = _synthetic_table("many", 45, 83)
        alpha = torch.full((tab.shape[0],), 0.5)
        dither = torch.rand(45, 83, generator=torch.Generator().manual_seed(0))
        return [(lambda: raster_kernel._launch(tab, 45, 83), {"zscan": 1}),
                (lambda: raster_kernel._launch_peels(tab, 45, 83, alpha, dither, 3.0, 2),
                 {"zscan_peels": 1})]
    if module == "table_kernel":
        table = torch.rand(3, 128, 11, generator=torch.Generator().manual_seed(0))
        ids = torch.arange(37 * 61, dtype=torch.int32).reshape(37, 61) % 400 - 3
        return [(lambda: table_kernel._launch(table, ids), {"lookup": 1})]
    if module == "motion_blur":
        color, vel = _blur_inputs(48, 80, 1)
        monkeypatch.setattr(motion_blur, "accumulate", motion_blur._launch)
        taps = dict(intensity=1.0, jitter=1.0, delta_time=1 / 60, samples=16, row_offset=0,
                    source=None)
        return [(lambda: motion_blur.motion_blur_sweep(color, vel, 3, dirs=16, steps=12),
                 {"motion_blur": 1}),
                (lambda: motion_blur._launch_taps(color, vel, 7, **taps),
                 {"motion_blur_taps": 1})]
    if module == "march_kernel":
        cfg, rays = _march_args("persp", "ssgi", 5, None, 10.0)
        return [(lambda a=a: march_kernel.launch(*a, cfg.steps, cfg.refine_steps),
                 {"ray_march": 1}) for a in rays]
    if module == "shade_kernel":
        # a shade pass launches the kernel once, either trace mode
        return [(lambda case=case: _shade_case(case), {"shade": 1})
                for case in ("sweep", "march")]
    assert module == "reproject_kernel"
    # a reprojection launches the prepare kernel and the blend, counted
    # by slots (the fetches between them take their plain versions here)
    return [(lambda case=case: _reproject_case(case),
             {"reproject_prepare": 1, f"reproject_{n}slot": 1})
            for case, n in (("traa", 1), ("ssgi", 2))]


@pytest.mark.parametrize("module", [
    "warp", "stencil", "hbao_kernel", "poisson_kernel", "poisson_taps", "sweep_kernel",
    "raster_kernel", "table_kernel", "motion_blur", "march_kernel", "reproject_kernel",
    "shade_kernel"])
def test_launch_census(host_kernels, monkeypatch, module):
    """Each host-built launch of a module's kernels adds 1 to its key of
    the launch census (``launches`` of ``ops/cuda_build.py``) and nothing
    to any other; ``clear()`` empties the census."""
    calls = _census_calls(module, monkeypatch)
    for call, want in calls:
        launches.clear()
        call()
        assert launches == collections.Counter(want)
    launches.clear()
    assert not launches
