"""Port neighborhood min/max (plain version) vs the JAX Pallas kernel
(interpret mode on the CPU). min and max are exact operations, so the
results must be equal bit for bit."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from realism_effects_tpu.ops.pallas.stencil import neighborhood_minmax as jmm
from realism_effects_tpu_torch.ops.cuda_build import launches
from realism_effects_tpu_torch.ops.stencil import neighborhood_minmax as tmm


@pytest.mark.parametrize("radius", [1, 2])
def test_minmax_matches_jax_exactly(radius):
    rng = np.random.default_rng(radius)
    h, w = 70, 200
    tex = rng.normal(size=(h, w, 4)).astype(np.float32)
    # skipped texels: channel 0 < 0 (about half), plus a fully masked patch
    tex[10:16, 20:30, 0] = -1.0
    launches.clear()
    mn, mx = tmm(torch.from_numpy(tex), radius)
    jmn, jmx = jmm(jnp.asarray(tex), radius)
    np.testing.assert_array_equal(mn.numpy(), np.asarray(jmn))
    np.testing.assert_array_equal(mx.numpy(), np.asarray(jmx))
    assert (mn.numpy() == 1e30).any()  # the fully masked patch
    assert not launches
