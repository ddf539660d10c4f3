"""The split frame (``EffectComposer._build_frame_fn(mesh)``): the
flagship frame and its temporal state held as row blocks over a mesh of
devices, against the unsplit frame, on the CPU.

A mesh of ``["cpu"] * n`` stands for the JAX tests' virtual CPU devices
(``tests/test_parallel.py:336-470``). Every per-shard stage runs the same
operations on the same values as the whole frame, so the split frame
equals the unsplit one exactly (``torch.equal``): the widths are 64, a
multiple of 16, so ATen's vector loops keep the same elements in their
vector bodies in a block and in the whole frame. The one comparison with
the JAX package, the split HBAO + TRAA frame against the JAX package's
unsharded ``_build_frame_fn()``, holds the bounds of
``tests/test_torch_render.py`` (max 1e-1, mean 5e-4, at most 0.5% of
pixels off by more than 1e-2); the JAX package's own sharded-equals-
unsharded test closes the chain.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import realism_effects_tpu as jre
import realism_effects_tpu_torch as tre
from realism_effects_tpu_torch.composer import _camera
from realism_effects_tpu_torch.core import math3d
from realism_effects_tpu_torch.core.camera import PerspectiveCamera as TCam
from realism_effects_tpu_torch.core.framebuffers import GBuffer, VelocityBuffer
from realism_effects_tpu_torch.ops import motion_blur as mb
from realism_effects_tpu_torch.ops import ssgi as tssgi
from realism_effects_tpu_torch.ops.copy import tree_map
from realism_effects_tpu_torch.ops.denoiser_compose import denoiser_compose
from realism_effects_tpu_torch.ops.temporal_reproject import (
    TemporalReprojectConfig, halo_rows, temporal_reproject)
from realism_effects_tpu_torch.parallel import halo
from realism_effects_tpu_torch.parallel.sharding import (RowBlocks, gather_rows,
                                                         is_blocks, make_mesh,
                                                         shard_pytree)
from realism_effects_tpu_torch.scene.shading import shade_direct

MAX_TOL, MEAN_TOL = 1e-1, 5e-4     # tests/test_torch_render.py:40-41
PIX_TOL, PIX_FRAC = 1e-2, 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree):
    """The tensor leaves of a state, row blocks joined."""
    out = []
    tree_map(lambda x: out.append(gather_rows(x) if is_blocks(x) else x),
             tree, is_leaf=is_blocks)
    return [x for x in out if isinstance(x, torch.Tensor)]


def _assert_same_state(got, want):
    a, b = _leaves(want), _leaves(got)
    assert len(a) == len(b) and len(a) >= 4
    for i, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y), f"state leaf {i}"


# ---------------------------------------------------------------------
# HBAO + TRAA through the frame function, as tests/test_parallel.py:336
# ---------------------------------------------------------------------

def _hbao_traa(m, device=None):
    """``tests/test_parallel.py``'s scene and stack at 64 x 64; the
    composer, its camera's matrices and the frame function's fixed
    arguments."""
    scene = m.Scene()
    scene.add(m.make_plane(16, m.Material(diffuse=(0.6, 0.6, 0.65, 1.0))))
    box = scene.add(m.make_box((1, 1, 1), m.Material(diffuse=(0.9, 0.3, 0.2, 1.0))))
    box.set_matrix(m.translation(0, 0.5, 0))
    cam = m.PerspectiveCamera(50, 1, 0.1, 100)
    cam.set_position(3, 2.5, 4)
    cam.look_at((0, 0.5, 0))
    kw = {} if device is None else {"device": device}
    comp = m.EffectComposer(scene, cam, 64, 64, **kw)
    comp.add_effect(m.HBAOEffect(spp=2))
    comp.add_effect(m.TRAAEffect())
    return comp, cam


def _torch_args(comp, cam):
    """The port's frame-function arguments of the JAX test's frame: one
    camera for all three, the composer's params, frame index 2."""
    cm = cam.matrices()
    comp._state = comp._init_state()
    return (comp.scene.pack("cpu"), comp.scene.model_matrices(),
            comp.scene.prev_model_matrices(), cm, cm, cm, comp._state,
            comp.build_params(), 2, None, comp.scene.lighting_params("cpu"))


@pytest.fixture(scope="module")
def jax_hbao_traa():
    """One frame of the JAX package's unsharded ``_build_frame_fn()`` on
    the HBAO + TRAA scene (the JAX test's arguments)."""
    comp, cam = _hbao_traa(jre)
    comp._packed = comp.scene.pack()
    comp._state = comp._init_state()
    cm = cam.matrices()
    args = (comp._packed, comp.scene.model_matrices(),
            comp.scene.prev_model_matrices(), cm, cm, cm, comp._state,
            comp.build_params(), jnp.int32(2), comp.scene.environment,
            comp.scene.lighting_params())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        img, _ = comp._build_frame_fn()(*args)
    return np.asarray(img)


@pytest.mark.parametrize("n", [2, 4])
def test_hbao_traa_frame_fn_split_equals_unsharded(n):
    """Two frames of HBAO(spp=2) + TRAA through the frame function, the
    raster included, with the state carried: split over ``n`` shards
    equals unsharded, image and every state leaf; the state goes in as
    blocks on the first frame and as the split frame's own on the
    second."""
    mesh = make_mesh(["cpu"] * n)
    ref, ref_cam = _hbao_traa(tre, "cpu")
    args = list(_torch_args(ref, ref_cam))
    fn = ref._build_frame_fn()
    want = []
    for f in range(2):
        img, args[6] = fn(*args[:8], f + 2, *args[9:])
        want.append(img)
    want_state = args[6]
    comp, cam = _hbao_traa(tre, "cpu")
    args = list(_torch_args(comp, cam))
    args[6] = shard_pytree(args[6], mesh)
    fn = comp._build_frame_fn(mesh)
    for f in range(2):
        img, args[6] = fn(*args[:8], f + 2, *args[9:])
        assert isinstance(img, RowBlocks) and len(img) == n
        assert [b.shape[0] for b in img] == [64 // n] * n
        assert torch.equal(gather_rows(img), want[f]), f"frame {f}"
    _assert_same_state(args[6], want_state)
    assert comp.last_placement == {"raster": "whole", "shade": "shard",
                                   "hbao": "shard", "traa": "shard"}


def test_split_hbao_traa_frame_matches_jax(jax_hbao_traa):
    """The split HBAO + TRAA frame on 4 shards against the JAX package's
    unsharded frame function on the same scene and arguments."""
    comp, cam = _hbao_traa(tre, "cpu")
    args = list(_torch_args(comp, cam))
    img, _ = comp._build_frame_fn(make_mesh(["cpu"] * 4))(*args)
    got = gather_rows(img).numpy()
    assert got.shape == jax_hbao_traa.shape and np.isfinite(got).all()
    err = np.abs(got - jax_hbao_traa)
    assert err.max() <= MAX_TOL, err.max()
    assert err.mean() <= MEAN_TOL, err.mean()
    assert (err.max(-1) > PIX_TOL).mean() <= PIX_FRAC


# ---------------------------------------------------------------------
# the flagship stack, as tests/test_parallel.py:388
# ---------------------------------------------------------------------

def _flagship(trace, h=96, w=64):
    """The JAX test's flagship scene and stack (SSGI + HBAO + motion blur
    + TRAA) at 96 x 64."""
    scene = tre.Scene()
    scene.add(tre.make_plane(20, tre.Material(diffuse=(0.6, 0.6, 0.65, 1.0))))
    box = scene.add(tre.make_box((1, 1, 1), tre.Material(diffuse=(0.9, 0.3, 0.2, 1.0))))
    box.set_matrix(tre.translation(0, 0.5, 0))
    sph = scene.add(tre.make_sphere(0.6, material=tre.Material(
        diffuse=(0.2, 0.5, 0.9, 1.0), roughness=0.2, metalness=0.8)))
    sph.set_matrix(tre.translation(1.5, 0.6, 0.5))
    cam = tre.PerspectiveCamera(50, w / h, 0.1, 100)
    comp = tre.EffectComposer(scene, cam, w, h, device="cpu")
    comp.add_effect(tre.SSGIEffect(steps=6, refine_steps=2, trace=trace,
                                   sweep_dirs=8, sweep_steps=12))
    comp.add_effect(tre.HBAOEffect(spp=2))
    comp.add_effect(tre.MotionBlurEffect(samples=4))
    comp.add_effect(tre.TRAAEffect())
    return comp, cam


def _frames(comp, cam, mesh, n=3):
    """``n`` frames through ``render()`` with the camera moving, so that
    the history blends, the velocity and motion blur are live, and SSGI
    reads last frame's composed output."""
    out = []
    for f in range(n):
        cam.set_position(3 + 0.15 * f, 2.5, 4)
        cam.look_at((0, 0.5, 0))
        out.append(comp.render(dt=1 / 60, mesh=mesh))
    return out


@pytest.mark.parametrize("trace,n", [("sweep", 4), ("march", 4), ("sweep", 8)])
def test_flagship_split_frame_equals_unsharded(trace, n, monkeypatch):
    """3 frames of the flagship stack on ``n`` shards equal the unsplit
    frames, every image and every leaf of the final state; every stage
    ran in its stated placement."""
    ref, cam = _flagship(trace)
    want = _frames(ref, cam, None)
    assert ref.last_placement == {}
    shards, marches = [], []
    mapper = halo.map_shards
    monkeypatch.setattr(halo, "map_shards",
                        lambda *a: shards.append(a[2]) or mapper(*a))
    march = tssgi.view_space_ray_march
    monkeypatch.setattr(tssgi, "view_space_ray_march",
                        lambda *a: marches.append(a[0].shape) or march(*a))
    comp, cam = _flagship(trace)
    got = _frames(comp, cam, make_mesh(["cpu"] * n))
    for f, (g, w) in enumerate(zip(got, want)):
        assert isinstance(g, RowBlocks) and len(g) == n
        assert torch.equal(gather_rows(g), w), f"frame {f}"
    _assert_same_state(comp._state, ref._state)
    assert comp.last_placement == {
        "raster": "whole", "shade": "shard", "ssgi": "shard", "hbao": "shard",
        "motion_blur": "shard", "traa": "shard"}
    # a frame: shade, the trace's glue, the reprojection, 2 SSGI and 2 AO
    # Poisson passes, HBAO, the AO texture and clamp, two composes, blur, TRAA
    assert len(shards) >= 3 * 12
    # each shard marches its own rows, two rays each
    assert len(marches) == (3 * n * 2 if trace == "march" else 0)


def test_whole_placed_effects_equal_unsharded():
    """GTAO and FXAA, placed whole (gathered, run, split), behind HBAO
    and TRAA: 2 frames split over 4 shards equal the unsplit frames, and
    the frame reports the placements."""
    def build():
        comp, cam = _hbao_traa(tre, "cpu")
        comp.add_effect(tre.GTAOEffect(spp=4))
        comp.add_effect(tre.FXAAEffect())
        return comp, cam

    ref, cam = build()
    want = _frames(ref, cam, None, 2)
    comp, cam = build()
    got = _frames(comp, cam, make_mesh(["cpu"] * 4), 2)
    for g, w in zip(got, want):
        assert torch.equal(gather_rows(g), w)
    _assert_same_state(comp._state, ref._state)
    assert comp.last_placement == {"raster": "whole", "shade": "shard",
                                   "hbao": "shard", "traa": "shard",
                                   "gtao": "whole", "fxaa": "whole"}


def test_save_state_same_bytes_split_or_not(tmp_path):
    """``save_state`` joins the blocks: the file of a split run has the
    same arrays, bit for bit, as the unsplit run's; ``state()`` joins
    them too."""
    paths = []
    for mesh in (None, make_mesh(["cpu"] * 4)):
        comp, cam = _hbao_traa(tre, "cpu")
        _frames(comp, cam, mesh, 2)
        paths.append(tmp_path / f"state_{mesh is None}.npz")
        comp.save_state(str(paths[-1]))
        hist = comp.state("traa")["history"]
        assert isinstance(hist, torch.Tensor) and hist.shape == (64, 64, 4)
    a, b = np.load(paths[0]), np.load(paths[1])
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert paths[0].read_bytes() == paths[1].read_bytes()


# ---------------------------------------------------------------------
# the ops that gained a row offset: a halo-extended block, cropped,
# equals its rows of the whole frame
# ---------------------------------------------------------------------

H, W = 48, 64


def _rng_inputs(seed=0):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    depth = 0.93 + 0.04 * (xx > W // 2) + 0.01 * np.sin(yy * 0.3)
    depth[: H // 6] = 1.0
    nrm = np.array([0.1, 0.9, 0.3]) + rng.uniform(-0.3, 0.3, (H, W, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    gb = GBuffer(diffuse=t(rng.random((H, W, 4))), normal=t(nrm),
                 roughness=t(rng.random((H, W))),
                 metalness=t(rng.random((H, W)) * (rng.random((H, W)) > 0.6)),
                 emissive=t(rng.random((H, W, 3)) * 0.1), depth=t(depth))
    vel = VelocityBuffer(velocity=t(rng.normal(0, 0.01, (H, W, 2))),
                         normal=t(nrm), depth=t(depth))
    last = VelocityBuffer(velocity=t(rng.normal(0, 0.01, (H, W, 2))),
                          normal=t(np.roll(nrm, 1, 0)), depth=t(np.roll(depth, 2, 0)))
    return dict(gb=gb, vel=vel, last=last, color=t(rng.uniform(0, 2, (H, W, 3))),
                tex=[t(np.concatenate([rng.uniform(0, 2, (H, W, 3)),
                                       rng.uniform(0, 8, (H, W, 1))], -1))
                     for _ in range(2)],
                acc=t(rng.uniform(0, 1.5, (H, W, 3))))


def _cams():
    cam = TCam(50, W / H, 0.1, 100)
    cam.set_position(3, 2.5, 4)
    cam.look_at((0, 0.5, 0))
    cm = _camera(cam, np.asarray(cam.matrix_world, np.float64),
                 np.asarray(cam.projection_matrix, np.float64))
    cam.set_position(3.1, 2.5, 4)
    cam.look_at((0, 0.5, 0))
    prev = _camera(cam, np.asarray(cam.matrix_world, np.float64),
                   np.asarray(cam.projection_matrix, np.float64))
    return cm, prev


def _lighting():
    scene = tre.Scene()
    scene.add_point_light((1.0, 2.0, 1.0), (3.0, 2.0, 1.0), distance=6.0)
    scene.sun_specular = 0.5
    return scene.lighting_params("cpu")


def _case(name):
    """(halo, fn(row0, frame_height, block tree) -> tensor(s), the
    whole-frame inputs)."""
    d = _rng_inputs()
    cm, prev = _cams()
    env = tre.build_equirect_env(tre.procedural_sky(32, 64), device="cpu")
    tcfg = TemporalReprojectConfig(
        texture_count=2, log_transform=True, reproject_specular=(False, True),
        neighborhood_clamp=(True, True), input_type="diffuse_specular")
    scfg = tssgi.SSGIConfig(steps=6, refine_steps=2, trace="march")
    sweep_cfg = tssgi.SSGIConfig(trace="sweep")
    if name == "uv_grid":
        return 0, lambda r0, fh, x: math3d.uv_grid(x.shape[0], W, "cpu", r0, fh), \
            d["color"]
    if name == "fwidth":
        return 1, lambda r0, fh, x: math3d.fwidth(x, r0, fh), d["gb"].normal
    if name == "shade":
        return 0, lambda r0, fh, gb: shade_direct(gb, cm, _lighting(), env, r0, fh), \
            d["gb"]
    if name == "temporal_reproject":
        return halo_rows(tcfg), lambda r0, fh, x: temporal_reproject(
            x["tex"], x["hist"], x["vel"], x["last"], cm, prev, tcfg,
            keep_data=1.0, roughness_tex=x["rough"], row_offset=r0,
            frame_height=fh), dict(tex=d["tex"], hist=[t * 0.5 for t in d["tex"]],
                                   vel=d["vel"], last=d["last"],
                                   rough=d["gb"].roughness)
    if name == "denoiser_compose":
        return 0, lambda r0, fh, x: denoiser_compose(
            x["tex"][0], x["tex"][1], x["gb"], cm, row_offset=r0,
            frame_height=fh), dict(tex=d["tex"], gb=d["gb"])
    if name in ("motion_blur_sweep", "motion_blur_taps"):
        op = mb.motion_blur_sweep if name.endswith("sweep") else mb.motion_blur
        src = d["color"]
        return 0, lambda r0, fh, x: op(x["c"], x["v"] * 20.0, 3, row_offset=r0,
                                       source=src), \
            dict(c=d["color"], v=d["vel"].velocity)
    if name == "ssgi_march_glue":
        def glue(r0, fh, x):
            p = tssgi._setup(x["gb"], env, cm, 3, scfg, r0, fh)
            traces = [tssgi.view_space_ray_march(p["view_pos"], ray, d["gb"].depth,
                                                 cm, p["r3"], 10.0, 10.0, scfg)
                      for ray in p["rays"]]
            return tssgi._shade(p, traces, d["vel"].velocity, d["acc"], x["c"],
                                env, cm, 3, scfg, 0.5)
        return 0, glue, dict(gb=d["gb"], c=d["color"])
    if name == "ssgi_prewarp":
        return tssgi.PREWARP_HALO, lambda r0, fh, x: tssgi._prewarp(
            x["acc"], x["vel"], math3d.uv_grid(x["acc"].shape[0], W, "cpu", r0, fh),
            r0, fh), dict(acc=d["acc"], vel=d["vel"])
    if name == "ssgi_env_fetch":
        def fetch(r0, fh, x):
            p = tssgi._setup(x["gb"], env, cm, 5, sweep_cfg, r0, fh)
            return tssgi._get_env_color(
                env, p["rays"][0], cm.view_matrix, p["roughness"],
                p["is_diffuse_sample"], p["is_env_sample"], 0.5, sweep_cfg,
                world_pos=p["world_pos"], frame=5, rows=p["rows"])
        return sweep_cfg.env_fetch_stride - 1, fetch, dict(gb=d["gb"])
    raise AssertionError(name)


def _block(tree, r0, hb, halo_):
    """Rows r0 .. r0 + hb of every frame-sized tensor of ``tree``,
    extended by ``halo_`` rows (the frame's edge rows repeated past it)."""
    return tree_map(lambda x: halo.edge_pad_rows(x, halo_)[r0: r0 + hb + 2 * halo_]
                    if isinstance(x, torch.Tensor) and x.ndim >= 2
                    and x.shape[0] == H else x, tree)


@pytest.mark.parametrize("name", [
    "uv_grid", "fwidth", "shade", "temporal_reproject", "denoiser_compose",
    "motion_blur_sweep", "motion_blur_taps", "ssgi_march_glue", "ssgi_prewarp",
    "ssgi_env_fetch"])
def test_row_offset_block_equals_whole_rows(name):
    """Each op that gained a row offset, on a halo-extended row block of
    a 48 x 64 frame at the top, in the middle (at an odd first row) and
    at the bottom, cropped: exactly those rows of the whole frame."""
    halo_, fn, inputs = _case(name)
    whole = fn(0, H, inputs)
    flat = lambda out: [x for x in (out if isinstance(out, (list, tuple)) else [out])]
    for r0, hb in ((0, 12), (17, 14), (36, 12)):
        got = fn(r0 - halo_, H, _block(inputs, r0, hb, halo_))
        for g, w in zip(flat(got), flat(whole)):
            assert torch.equal(halo.crop_rows(g, halo_), w[r0: r0 + hb]), \
                f"{name} rows {r0}..{r0 + hb}"
