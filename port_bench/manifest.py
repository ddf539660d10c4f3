"""The manifest (``BENCHMARK.json``) and the files each of its names
resolves to.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; the configuration's ``file`` is ``configs/<config>.json``, the
traffic mix is ``traffic/<traffic>.json``; a per-layer metric is read by
``metrics/<metric>.py``; a scene or motion generator is
``scenes/<name>.py`` or ``motions/<name>.py``; a kernel's bytes and
operations a launch are ``kernels/<kernel>.py``. Nothing here knows a
cell by name: a new cell is new files and new entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_manifest(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def load_module(kind: str, name: str, base: Path = HERE):
    """``<base>/<kind>/<name>.py`` as a module (names may hold ``.`` and
    ``-``, so it is loaded by its path)."""
    path = Path(base) / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(
        f"port_bench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with everything it names, loaded."""

    name: str
    chips: int
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    end_to_end: list      # the manifest's end-to-end metrics this cell reports
    per_layer: list       # the per-layer metrics this cell reports
    base: Path            # the directory the cell's files were found under

    def reader(self, metric: str):
        return load_module("metrics", metric, self.base)

    def generator(self, kind: str, name: str):
        return load_module(kind, name, self.base)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, manifest: dict | None = None, root: Path = ROOT,
            base: Path = HERE) -> Cell:
    """The cell ``name`` of ``manifest`` (by default the repository's),
    its files read from ``base``."""
    manifest = load_manifest(root) if manifest is None else manifest
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in the manifest "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    cfg_entry = configs[w["config"]]
    with open(Path(root) / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(Path(base) / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    cell = Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=[m for m in manifest["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in manifest["per_layer"] if _reports(m, name)],
                base=Path(base))
    # every name the cell gives has its file
    for m in cell.per_layer:
        cell.reader(m["name"])
    cell.generator("scenes", config["scene"])
    for motion in [traffic["camera"]] + traffic.get("objects", []):
        cell.generator("motions", motion["motion"])
    for launch in traffic.get("kernel_launches", []):
        load_module("kernels", launch["kernel"], base)
    return cell
