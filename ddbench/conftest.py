"""Fixtures of the benchmark's CPU tests: a copy of the benchmark whose
cells are cut to a size the CPU runs in a second or two."""
from __future__ import annotations

import json
import shutil

import pytest
import torch

from ddbench import harness, registry

#: what the tiny copies change: the file layout, the pool, the host time,
#: the traffic
TINY_FILES = {"tiles_per_file": 16, "file_bytes": 16 * 100 * 100 * 4,
              "store_tiles": 512}
TINY_STATIC = {"executors": 4, "pool_min": 4, "pool_max": 4, **TINY_FILES}
TINY_ELASTIC = {"pool_max": 8, "host_s_per_request": 0.01, **TINY_FILES}
TINY_CLOSED = {"files": 40, "warmup": {"files": 4, "requests": 8}}
TINY_OPEN = {"arrivals": {"kind": "sine", "mean_per_s": 40.0,
                          "amplitude_per_s": 38.0, "period_s": 2.0,
                          "phase": 0.0},
             "duration_s": 2.0}
#: window (s) of a tiny run, by loop
TINY_SECONDS = {"closed": 1.0, "open": 2.0}


def _shrink_config(cfg: dict) -> dict:
    if cfg.get("provisioner"):
        return dict(cfg, provisioner=dict(cfg["provisioner"], max_executors=8),
                    **TINY_ELASTIC)
    return dict(cfg, **TINY_STATIC)


@pytest.fixture
def tiny_bench(tmp_path, monkeypatch):
    """``BENCHMARK.json``'s cells, configurations and metrics, and those held
    out of it, with the configurations and traffic cut to CPU size,
    installed as the registry's root for the test; a request due is waited
    for 2 s past the close."""
    torch.set_num_threads(1)
    real = registry.benchmark(held=True)
    here = tmp_path / "ddbench"
    for sub in ("metrics", "references"):
        shutil.copytree(registry.HERE / sub, here / sub)
    (here / "configs").mkdir()
    (here / "workloads").mkdir()
    bench = json.loads(json.dumps(real))
    for c in bench["configs"]:
        cfg = _shrink_config(registry.config(real, c["name"]))
        c["file"] = f"ddbench/configs/{c['name']}.json"
        (tmp_path / c["file"]).write_text(json.dumps(cfg))
    for wl in bench["workloads"]:
        mix = registry.traffic(wl["traffic"])
        mix = dict(mix, **(TINY_CLOSED if mix["loop"] == "closed"
                           else TINY_OPEN))
        (here / "workloads" / f"{wl['traffic']}.json").write_text(
            json.dumps(mix))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(registry, "ROOT", tmp_path)
    monkeypatch.setattr(registry, "HERE", here)
    monkeypatch.setattr(harness, "GRACE_S", 2.0)
    return bench


def seconds_of(bench: dict, cell: str) -> float:
    wl = registry.cell(bench, cell)
    return TINY_SECONDS[registry.traffic(wl["traffic"])["loop"]]
