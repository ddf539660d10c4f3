"""The port's row sharding (``realism_effects_tpu_torch/parallel``): the
split frame's primitives, the bounded-window wrappers run per shard
through them, and the row offset of the Poisson and HBAO kernels' plain
versions, on the CPU.

A mesh of ``["cpu"] * n`` stands for the JAX tests' virtual CPU devices:
every shard runs the plain version of its kernel on its halo-extended
rows, and the sharded results must equal the unsharded ones exactly (the
same operations on the same values; the widths are multiples of 16, so
ATen's vector loops keep the same elements in their vector bodies in a
block and in the whole frame). The one comparison with the JAX package,
the denoise pass on a row block at ``row_offset = 8``, holds the
tolerance of ``tests/test_torch_poisson.py`` (5e-4 for one pass).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realism_effects_tpu.core.framebuffers import GBuffer as JGBuffer
from realism_effects_tpu.ops import poisson_denoise as jpd
from realism_effects_tpu_torch.core.camera import PerspectiveCamera as TCam
from realism_effects_tpu_torch.core.framebuffers import GBuffer
from realism_effects_tpu_torch.ops import (hbao_kernel, poisson_denoise,
                                           poisson_kernel, warp)
from realism_effects_tpu_torch.ops.ao import AOConfig
from realism_effects_tpu_torch.ops.poisson_denoise import PoissonDenoiseConfig
from realism_effects_tpu_torch.parallel import halo, sharding
from realism_effects_tpu_torch.parallel.sharding import make_mesh


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _surface(h, w, seed):
    """Depth with a step and a background band, unit normals (zero on
    the background), roughness."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    depth = 0.85 + 0.1 * (xx > w // 2) + 0.002 * np.sin(yy * 0.2)
    depth[: h // 8] = 1.0
    nrm = np.array([0.1, 0.2, 0.97]) + rng.uniform(-0.1, 0.1, (h, w, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[: h // 8] = 0.0
    planes = dict(
        diffuse=np.zeros((h, w, 4)), normal=nrm, roughness=rng.random((h, w)),
        metalness=np.zeros((h, w)), emissive=np.zeros((h, w, 3)), depth=depth)
    return {k: v.astype(np.float32) for k, v in planes.items()}


def _gbuffer(planes, rows=slice(None)):
    return GBuffer(**{k: torch.from_numpy(np.ascontiguousarray(v[rows]))
                      for k, v in planes.items()})


def _textures(h, w, n, seed):
    rng = np.random.default_rng(seed)
    return [np.concatenate([rng.random((h, w, 3)) * 2.0,
                            rng.integers(0, 40, (h, w, 1))], -1).astype(np.float32)
            for _ in range(n)]


def _camera(h, w):
    cam = TCam(50, w / h, 0.1, 80)
    cam.set_position(0.3, 1.5, 5.0)
    cam.look_at((0, 0.5, 0))
    return cam.matrices()


def _extended_rows(h, lo, hi, halo_):
    """Global rows of the block [lo, hi) extended by ``halo_`` rows,
    clamped to the frame (the exchanged halo's rows)."""
    return np.clip(np.arange(lo - halo_, hi + halo_), 0, h - 1)


# ---------------------------------------------------------------------
# the repair: the row offset of the Poisson and HBAO plain versions
# ---------------------------------------------------------------------

@pytest.mark.parametrize("slots", [(False, False), (True,)])
@pytest.mark.parametrize("lo,hi", [(0, 16), (16, 48), (48, 64)])
def test_poisson_block_with_row_offset_equals_unsharded(slots, lo, hi):
    """The plain pass on a halo-extended row block, with ``row_offset``
    and ``resolution`` and cropped, equals the unsharded pass on those
    rows: the uv, the flatness's bottom edge, the tap clamp and the noise
    phase are the whole frame's."""
    h, w = 64, 48
    planes = _surface(h, w, 3)
    texs = [torch.from_numpy(t) for t in _textures(h, w, len(slots), 4)]
    if slots == (True,):
        texs = [texs[0][..., [0, 0, 0, 3]].contiguous()]
    cfg = PoissonDenoiseConfig(is_specular=(False, True)[:len(slots)])
    bundle, ch = poisson_kernel.pack_bundle(texs, _gbuffer(planes), slots)
    want = poisson_kernel.poisson_pass_plain(bundle, ch, slots, 7, cfg)
    aky = poisson_kernel.tap_halo(cfg.radius, h, w)
    rows = torch.from_numpy(_extended_rows(h, lo, hi, aky))
    got = poisson_kernel.poisson_pass_plain(bundle[rows], ch, slots, 7, cfg,
                                            row_offset=lo - aky,
                                            resolution=(h, w))
    assert torch.equal(got[aky: aky + hi - lo], want[lo:hi])


def test_poisson_unfused_block_with_row_offset_equals_unsharded(monkeypatch):
    """The same for the unfused pass (``USE_FUSED_PASS`` off)."""
    monkeypatch.setattr(poisson_kernel, "USE_FUSED_PASS", False)
    h, w, lo, hi = 64, 48, 16, 32
    planes = _surface(h, w, 5)
    texs = [torch.from_numpy(t) for t in _textures(h, w, 2, 6)]
    cfg = PoissonDenoiseConfig(is_specular=(False, True))
    want = poisson_denoise.poisson_denoise_pass(texs, _gbuffer(planes), 9, cfg)
    pad = 8
    rows = _extended_rows(h, lo, hi, pad)
    got = poisson_denoise.poisson_denoise_pass(
        [t[torch.from_numpy(rows)] for t in texs], _gbuffer(planes, rows), 9, cfg,
        row_offset=lo - pad, resolution=(h, w))
    for g, w_ in zip(got, want):
        assert torch.equal(g[pad: pad + hi - lo], w_[lo:hi])


def test_poisson_row_offset_matches_jax():
    """A 32 x 48 row block at ``row_offset = 8`` of a 64 x 48 frame
    through the port's pass and the JAX ``poisson_denoise_pass(...,
    row_offset=, resolution=)`` (jitted, as ``tests/test_torch_poisson.py``
    calls it), within that file's one-pass bound."""
    h, w, r0, hb = 64, 48, 8, 32
    planes = {k: v[r0: r0 + hb] for k, v in _surface(h, w, 11).items()}
    texs = _textures(hb, w, 2, 12)
    kw = dict(is_specular=(False, True))
    jcfg, tcfg = jpd.PoissonDenoiseConfig(**kw), PoissonDenoiseConfig(**kw)
    jgb = JGBuffer(**{k: jnp.asarray(v) for k, v in planes.items()})
    want = jax.jit(lambda ts, gb: jpd.poisson_denoise_pass(
        ts, gb, jnp.int32(5), jcfg, row_offset=r0, resolution=(h, w)))(
        [jnp.asarray(t) for t in texs], jgb)
    got = poisson_denoise.poisson_denoise_pass(
        [torch.from_numpy(t) for t in texs], _gbuffer(planes), 5, tcfg,
        row_offset=r0, resolution=(h, w))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=5e-4,
                                   rtol=5e-4)
    # and the offset matters: the same block as a frame of its own differs
    alone = poisson_denoise.poisson_denoise_pass(
        [torch.from_numpy(t) for t in texs], _gbuffer(planes), 5, tcfg)
    assert float((alone[0] - got[0]).abs().max()) > 1e-2


@pytest.mark.parametrize("cfg", [AOConfig(), AOConfig(spp=3, window_ky=4, window_kx=3),
                                 AOConfig(spp=40, distance=0.3)])
@pytest.mark.parametrize("lo,hi", [(0, 16), (24, 40), (48, 64)])
def test_hbao_block_with_row_offset_equals_unsharded(cfg, lo, hi):
    """The plain HBAO on a row block extended by ``window_ky`` rows of
    depth (and edge-padded normals), with ``row_offset`` and the global
    height and cropped, equals the unsharded HBAO on those rows."""
    h, w = 64, 48
    planes = _surface(h, w, 1)
    depth = torch.from_numpy(planes["depth"])
    nrm = torch.from_numpy(planes["normal"])
    m = _camera(h, w)
    want = hbao_kernel.hbao_fused_plain(depth, nrm, m, 3, cfg)
    ky = cfg.window_ky
    rows = torch.from_numpy(_extended_rows(h, lo, hi, ky))
    got = hbao_kernel.hbao_fused_plain(
        depth[rows], halo.edge_pad_rows(nrm[lo:hi], ky), m, 3, cfg,
        row_offset=lo - ky, height=h)
    assert torch.equal(got[ky: ky + hi - lo], want[lo:hi])


# ---------------------------------------------------------------------
# parallel/: mesh, placement, halo exchange
# ---------------------------------------------------------------------

@pytest.mark.parametrize("rows,n,halo_", [(64, 4, 1), (64, 8, 5), (16, 8, 3),
                                           (16, 8, 5), (12, 4, 0)])
def test_halo_exchange_matches_edge_padding(rows, n, halo_):
    """Each extended block is the edge-padded frame's rows around it; a
    halo larger than a block (16 rows over 8 shards: 2 a block) takes
    rows from blocks several hops away."""
    x = torch.arange(rows * 6 * 2, dtype=torch.float32).reshape(rows, 6, 2)
    mesh = make_mesh(["cpu"] * n)
    ext = halo.halo_exchange_rows(sharding.shard_rows(x, mesh), halo_)
    padded = halo.edge_pad_rows(x, halo_)
    h_loc = rows // n
    for i, e in enumerate(ext):
        assert torch.equal(e, padded[i * h_loc: (i + 1) * h_loc + 2 * halo_])


def test_replicate_for_rolls():
    """Tensors and None stay as they are; row blocks are joined."""
    a = torch.ones(2)
    assert sharding.replicate_for_rolls(a) is a
    assert sharding.replicate_for_rolls(a, None) == (a, None)
    x = torch.arange(8.0).reshape(4, 2)
    assert torch.equal(sharding.replicate_for_rolls(
        sharding.shard_rows(x, make_mesh(["cpu"] * 2))), x)


def test_make_mesh_needs_cuda_or_named_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    assert make_mesh(["cpu", "cpu"]) == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError):
        make_mesh([])


def test_shard_pytree_rule():
    """Image-like leaves (ndim >= 2, H divisible by the mesh size and at
    least it) become row blocks; the rest is copied to every device;
    non-tensors stay. A bare tensor is a tree of one leaf."""
    mesh = make_mesh(["cpu"] * 4)
    tree = {"img": torch.zeros(8, 3, 2), "odd": torch.zeros(6, 3),
            "vec": torch.zeros(8), "short": torch.zeros(2, 5),
            "list": [torch.zeros(4, 4), 3], "name": "x"}
    out = sharding.shard_pytree(tree, mesh)
    assert [tuple(b.shape) for b in out["img"]] == [(2, 3, 2)] * 4
    assert [tuple(b.shape) for b in out["odd"]] == [(6, 3)] * 4
    assert [tuple(b.shape) for b in out["vec"]] == [(8,)] * 4
    assert [tuple(b.shape) for b in out["short"]] == [(2, 5)] * 4
    assert [tuple(b.shape) for b in out["list"][0]] == [(1, 4)] * 4
    assert out["list"][1] == 3 and out["name"] == "x"
    assert torch.equal(sharding.gather_rows(out["img"]), tree["img"])
    assert [tuple(b.shape) for b in sharding.shard_pytree(torch.zeros(8, 2), mesh)] \
        == [(2, 2)] * 4
    assert all(tuple(b.shape) == (8,)
               for b in sharding.shard_pytree(torch.zeros(8), mesh))


# ---------------------------------------------------------------------
# the bounded-window wrappers per shard, and the sharded denoise
# ---------------------------------------------------------------------

def _warp_args(h, w, seed):
    rng = np.random.default_rng(seed)
    tex = torch.tensor(rng.random((h, w, 4)), dtype=torch.float32)
    ty = torch.tensor(rng.integers(-20, h + 20, (h, w)), dtype=torch.int32)
    tx = torch.tensor(rng.integers(-40, w + 40, (h, w)), dtype=torch.int32)
    fy = torch.tensor(rng.random((h, w)), dtype=torch.float32)
    fx = torch.tensor(rng.random((h, w)), dtype=torch.float32)
    return tex, ty, tx, fy, fx


def _route(name, h, w):
    """One route on the h x w inputs: (the unsharded call, the call on a
    shard ``local(row0, *blocks)`` with its block's global first row,
    its halo, the inputs with their rows first)."""
    planes = _surface(h, w, 2)
    gb = _gbuffer(planes)
    tex, ty, tx, fy, fx = _warp_args(h, w, 3)
    if name == "warp_multi":
        # the (N, H, W) targets and results travel rows first
        tys = torch.stack([ty, ty.flip(0), ty // 2])
        txs = torch.stack([tx, tx.flip(1), tx // 2])
        rows_first = lambda out: tuple(o.movedim(1, 0) for o in out)
        return (lambda: rows_first(warp.window_warp_multi(tex[..., 0], tys, txs,
                                                          ky=6, kx=30)),
                lambda row0, t, y, x: rows_first(warp.window_warp_multi(
                    t, y.movedim(-1, 0) - row0, x.movedim(-1, 0), ky=6, kx=30)),
                6, (tex[..., 0], tys.movedim(0, -1), txs.movedim(0, -1)))
    if name.startswith("warp_"):
        mode = name[5:]
        return (lambda: warp.window_warp(tex, ty, tx, fy, fx, ky=8, mode=mode, kx=30),
                lambda row0, t, y, x, fy_, fx_: warp.window_warp(
                    t, y - row0, x, fy_, fx_, ky=8, mode=mode, kx=30),
                8 + warp._HALO_EXTRA[mode], (tex, ty, tx, fy, fx))
    if name.startswith("hbao"):
        cfg = AOConfig() if name == "hbao" else AOConfig(spp=8, window_ky=3)
        m = _camera(h, w)
        return (lambda: hbao_kernel.hbao_fused(gb.depth, gb.normal, m, 2, cfg),
                lambda row0, d, n: hbao_kernel.hbao_fused(
                    d, n, m, 2, cfg, row_offset=row0, frame_height=h),
                cfg.window_ky, (gb.depth, gb.normal))
    texs = [torch.from_numpy(t) for t in _textures(h, w, 2, 4)]
    cfg, slots = PoissonDenoiseConfig(is_specular=(False, True)), None
    if name == "poisson_ao":
        texs = [texs[0][..., [0, 0, 0, 3]].contiguous()]
        cfg, slots = PoissonDenoiseConfig(), (True,)
    return (lambda: poisson_kernel.poisson_pass_fused(texs, gb, 3, cfg,
                                                      scalar_slots=slots),
            lambda row0, ts, g: poisson_kernel.poisson_pass_fused(
                list(ts), g, 3, cfg, row_offset=row0, resolution=(h, w),
                scalar_slots=slots),
            poisson_kernel.tap_halo(cfg.radius, h, w), (texs, gb))


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(o)]


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("name", [
    "warp_nearest", "warp_bilinear", "warp_catrom", "warp_catrom5", "warp_multi",
    "hbao", "hbao_narrow", "poisson_2tex", "poisson_ao"])
def test_sharded_route_equals_unsharded(name, n):
    """Each bounded-window wrapper run per shard through the split
    frame's ``map_shards``, on its halo-extended row block with the
    block's global row offset, joins to its unsharded call exactly."""
    whole, local, halo_, inputs = _route(name, 64, 48)
    want = _flat(whole())
    mesh = make_mesh(["cpu"] * n)
    got = _flat(sharding.gather_pytree(
        halo.map_shards(local, mesh, halo_, *sharding.split_images(inputs, mesh))))
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape and torch.equal(g, w_)


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("iterations", [1, 2])
@pytest.mark.parametrize("fused", [True, False])
def test_poisson_denoise_sharded_equals_unsharded(n, iterations, fused,
                                                  monkeypatch):
    monkeypatch.setattr(poisson_kernel, "USE_FUSED_PASS", fused)
    h, w = 64, 48
    gb = _gbuffer(_surface(h, w, 8))
    texs = [torch.from_numpy(t) for t in _textures(h, w, 2, 9)]
    cfg = PoissonDenoiseConfig(iterations=iterations, is_specular=(False, True))
    want = poisson_denoise.poisson_denoise(texs, gb, 3, cfg)
    got = halo.poisson_denoise_sharded(texs, gb, 3, cfg, make_mesh(["cpu"] * n))
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
