"""The control (the reference with its stage buffers in bfloat16) fails
the comparison's limits, at a size a test run holds; on the card,
``python3 -m port_bench.control`` reads it at the cells' own sizes."""

import pytest
import torch

from port_bench import check, control


@pytest.mark.parametrize("cell", ["hbao_traa-1080p-orbit", "flagship-2160p-orbit-box"])
def test_control_is_not_correct(cell, tiny):
    torch.set_num_threads(1)
    c = tiny(cell)
    r = control.readings(c, 7, 0.3, torch.device("cpu"))
    ok, _ = check.judge(r["program"], c.traffic["compare"]["limits"])
    assert ok
    ok, rows = check.judge(r["control"], c.traffic["compare"]["limits"])
    assert not ok, rows
