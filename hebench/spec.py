"""Everything the harness knows of a cell, found by name: the cell and its
metrics in `BENCHMARK.json` at the checkout's root, the configuration in
`configs/<config>.json`, the traffic mix in `traffic/<mix>.json`, each
metric's reader in `metrics/<metric>.py`, each cell's frozen work in
`work/<cell>.json`.  A new cell or metric is a new file and an entry in
`BENCHMARK.json`; the harness's code names none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    return cells[name]


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def frozen(cell: str) -> dict | None:
    """The frozen work of one request of `cell`, or None where none was
    frozen."""
    path = HERE / "work" / f"{cell}.json"
    return _json(path) if path.exists() else None


def reader(metric: str):
    """`read(rec)` of `metrics/<metric>.py`: the metric's value from the
    run's record, or None where the run gave it nothing to read."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"hebench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The cell's end-to-end metrics (those that list it under `workloads`,
    and those without the key), or with `traced` its per-layer ones (those
    that list it: a per-layer metric always names its cells)."""
    if traced:
        return [m for m in bench["per_layer"] if cell in m["workloads"]]
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
