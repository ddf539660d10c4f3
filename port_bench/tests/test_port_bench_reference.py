"""The frozen plain reference against the port's CPU route (the plain
versions of its kernels) at a tiny size: the same inputs give the same
frames and state, bit for bit; and the reference loads nothing of the
program."""

import subprocess
import sys

import pytest
import torch

from port_bench import check
from port_bench.inputs import Inputs
from port_bench.manifest import ROOT
from port_bench.reference import port as ref_pkg
from port_bench.rig import Rig


@pytest.mark.parametrize("cell", ["hbao_traa-1080p-orbit", "flagship-2160p-orbit-box"])
def test_reference_equals_the_port_on_the_cpu(cell, tiny):
    import realism_effects_tpu_torch as program

    torch.set_num_threads(1)
    c = tiny(cell)
    inputs = Inputs(c, 2 ** 31 + 99)
    sides = [Rig(pkg, c, inputs, "cpu") for pkg in (program, ref_pkg)]
    for f in range(3):
        out = [check.outputs(rig.render(f), rig.state()) for rig in sides]
        assert out[0].keys() == out[1].keys()
        for k in out[0]:
            assert torch.equal(out[0][k], out[1][k]), (f, k)
    assert float(out[0]["image"].abs().max()) > 0.0


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, port_bench.reference.port, port_bench.check; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('realism_effects_tpu_torch', 'realism_effects_tpu', 'jax', 'bench')); "
            "print(bad); sys.exit(1 if bad else 0)")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert done.returncode == 0, done.stdout + done.stderr


def test_reference_runs_no_kernel():
    """The copy holds the plain bodies only: no module binds a kernel."""
    root = ROOT / "port_bench" / "reference" / "port"
    for path in root.rglob("*.py"):
        text = path.read_text()
        assert "cuda_build" not in text and "data_ptr" not in text, path
