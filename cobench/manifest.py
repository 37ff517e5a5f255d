"""Finds every part of a cell by its name: the cell in `BENCHMARK.json`, its
configuration in `configs/<name>.json`, its traffic mix in
`traffic/<name>.json`, the prover module its configuration names in
`provers/<name>.py`, and each per-layer metric's reader in
`metrics/<name>.py`.  A later cell, configuration, mix or metric is a new
file and a new entry; no file here needs an edit for it."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def load_benchmark(path: Path | None = None) -> dict:
    with open(path or REPO / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def _json(kind: str, name: str, root: Path | None) -> dict:
    with open((root or HERE) / kind / f"{name}.json") as f:
        return json.load(f)


def load_config(name: str, root: Path | None = None) -> dict:
    return _json("configs", name, root)


def load_traffic(name: str, root: Path | None = None) -> dict:
    return _json("traffic", name, root)


def prover(name: str):
    """The module `provers/<name>.py`, whose `Cell` runs the proofs."""
    return importlib.import_module(f"{__package__}.provers.{name}")


def metric_reader(name: str, root: Path | None = None):
    """`read(run) -> float | None` of `metrics/<name>.py` (names may hold
    dots, so the file is loaded by its path)."""
    path = (root or HERE) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{__package__}.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of `cell` reports: per-layer with a trace,
    end-to-end without."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])]
