"""The control of the comparison, and the readings its limits are set
from.

    python3 -m port_bench.control --workload <cell> --seeds 1,2,3 [--seconds 2]

For each seed, in one process: the program's run (warm-up and a window of
``--seconds`` at the cell's own size and load) held against the plain
reference, as every benchmark run does (the lower readings); then the
control in the program's place — the reference with every buffer that
crosses a stage stored in bfloat16 (``reference.lower_precision``), the
precision below the configuration's float32 — held against the same
reference: its own warm-up frames with its stages against their
independent references, and the window's last frames replayed from the
program's state before them (the upper readings). Prints one JSON
line a seed. The benchmark's runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from port_bench import check, manifest
from port_bench.run import program_run


def readings(cell, seed: int, seconds: float, device) -> dict:
    """{"program": {frame: numbers}, "control": {frame: numbers}}."""
    inputs, start_prog, win, _ = program_run(cell, seed, seconds, False, device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref, records = check.reference_start(cell, inputs, device)
    out = {"program": {"start": check.numbers(
               {k: v.to(device) for k, v in start_prog.items()}, ref)[0],
               "stages": check.stage_numbers(records)[0]}}
    del records
    low, records = check.reference_start(cell, inputs, device, lower=True)
    out["control"] = {"start": check.numbers(low, ref)[0],
                      "stages": check.stage_numbers(records)[0]}
    del ref, low, records
    span = (win["state_in"], win["first"], win["last"], device)
    ref = check.reference_step(cell, inputs, *span)
    low = check.reference_step(cell, inputs, *span, lower=True)
    out["program"]["last"] = check.numbers(check.outputs(win["image"], win["state_out"]), ref)[0]
    out["control"]["last"] = check.numbers(low, ref)[0]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    cell = manifest.resolve(args.workload)
    if not torch.cuda.is_available():
        print("port_bench.control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(cell, seed, args.seconds, device)
        print(json.dumps({"workload": args.workload, "seed": seed, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
