"""Finds everything by the names in ``BENCHMARK.json``.

  cell           an entry of ``workloads``: a configuration and a traffic mix
  configuration  the JSON file its ``configs`` entry names
  traffic mix    ``ddbench/workloads/<traffic>.json``
  metric         ``ddbench/metrics/<name>.py``, whose ``read(run)`` returns
                 the value or None where the run has nothing to read
  reference      ``ddbench/references/<name>.py``, named by the
                 configuration's ``reference`` key
  held entries   ``ddbench/held/<cell>.json``: a cell built and measured
                 but held out of ``BENCHMARK.json`` (its ``about`` says why),
                 with its configuration and metrics; ``benchmark(held=True)``
                 adds them, for the scripts that measure such a cell again

So a later cell, configuration or metric is a new file and a new entry, and
no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def benchmark(root: Path | None = None, held: bool = False) -> dict:
    bench = json.loads(((root or ROOT) / "BENCHMARK.json").read_text())
    if held:
        for path in sorted((HERE / "held").glob("*.json")):
            extra = json.loads(path.read_text())
            for key in ("configs", "workloads", "end_to_end", "per_layer"):
                bench[key] = bench[key] + extra.get(key, [])
    return bench


def cell(bench: dict, name: str) -> dict:
    for wl in bench["workloads"]:
        if wl["name"] == name:
            return wl
    raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: "
                   f"{[w['name'] for w in bench['workloads']]})")


def config(bench: dict, name: str, root: Path | None = None) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads(((root or ROOT) / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, here: Path | None = None) -> dict:
    path = (here or HERE) / "workloads" / f"{name}.json"
    return json.loads(path.read_text())


def metrics(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell reports: its end-to-end ones with
    ``trace`` off, its per-layer ones with it on."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(name: str, here: Path | None = None):
    """The ``read`` function of metric ``name``."""
    path = (here or HERE) / "metrics" / f"{name}.py"
    return _load(path, f"ddbench_metric_{name.replace('.', '_')}").read


def reference(name: str, here: Path | None = None):
    path = (here or HERE) / "references" / f"{name}.py"
    return _load(path, f"ddbench_ref_{name}")
