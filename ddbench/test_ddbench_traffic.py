"""The traffic generator and the registry that finds cells by name."""
from __future__ import annotations

import collections
import json

import numpy as np
import pytest

from ddbench import registry, traffic

BIG_SEED = 2**33 + 7   # seeds may pass 32 bits

CLOSED = {"loop": "closed", "locality": 10, "files": 50, "epochs": 2,
          "warmup": {"files": 4, "requests": 10}}
SINE = {"loop": "open", "locality": 30,
        "arrivals": {"kind": "sine", "mean_per_s": 395.0,
                     "amplitude_per_s": 375.0, "period_s": 30.0,
                     "phase": 0.0},
        "duration_s": 30.0, "warmup": {"files": 2, "requests": 4}}


def test_closed_loop_names_every_file_locality_times_per_epoch():
    p = traffic.plan(CLOSED, BIG_SEED, 30.0)
    assert len(p) == 2 * 50 * 10 and not p.due.any()
    first, second = p.files[:500], p.files[500:]
    assert collections.Counter(first) == {f: 10 for f in range(50)}
    assert collections.Counter(second) == {f: 10 for f in range(50, 100)}
    assert set(p.warmup_files) == {100, 101, 102, 103}
    assert p.n_files == 104


def test_a_seed_shuffles_the_same_work():
    a = traffic.plan(CLOSED, BIG_SEED, 30.0)
    b = traffic.plan(CLOSED, BIG_SEED + 1, 30.0)
    assert not np.array_equal(a.files, b.files)
    assert sorted(a.files) == sorted(b.files)
    again = traffic.plan(CLOSED, BIG_SEED, 30.0)
    assert np.array_equal(a.files, again.files)
    s1, s2 = traffic.plan(SINE, 1, 30.0), traffic.plan(SINE, BIG_SEED, 30.0)
    assert np.array_equal(s1.due, s2.due)
    assert sorted(s1.files) == sorted(s2.files)


def test_sine_arrivals_follow_the_rate():
    p = traffic.plan(SINE, BIG_SEED, 30.0)
    assert len(p) == pytest.approx(395 * 30, abs=1)
    assert np.all(np.diff(p.due) > 0) and p.due[-1] < 30.0
    per_s = np.histogram(p.due, bins=30, range=(0, 30))[0]
    assert per_s.argmax() in (7, 8) and per_s.argmin() in (22, 23)
    assert per_s.max() == pytest.approx(395 + 375, abs=3)
    counts = collections.Counter(p.files)
    assert max(counts.values()) == 30
    assert p.n_files == len(counts) + 2


def test_an_open_loop_window_offers_what_is_due_before_it_closes():
    short = traffic.plan(SINE, BIG_SEED, 10.0)
    whole = traffic.plan(SINE, BIG_SEED, 30.0)
    assert np.all(short.due < 10.0)
    assert np.array_equal(short.files, whole.files[:len(short)])
    assert short.n_files == whole.n_files


def test_constant_arrivals():
    mix = dict(SINE, arrivals={"kind": "constant", "rate_per_s": 100.0},
               duration_s=2.0)
    p = traffic.plan(mix, 3, 2.0)
    assert len(p) == 200
    assert p.due[0] == pytest.approx(0.005, abs=1e-4)


def test_the_registry_finds_a_cell_configuration_and_metric_added_as_files(
        tmp_path, monkeypatch):
    here = tmp_path / "ddbench"
    for sub in ("configs", "workloads", "metrics"):
        (here / sub).mkdir(parents=True)
    (here / "configs" / "new_cfg.json").write_text(json.dumps({"x": 1}))
    (here / "workloads" / "new_mix.json").write_text(json.dumps(CLOSED))
    (here / "metrics" / "new_metric.layer.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench = {
        "configs": [{"name": "new_cfg",
                     "file": "ddbench/configs/new_cfg.json"}],
        "workloads": [{"name": "new.cell", "config": "new_cfg",
                       "traffic": "new_mix", "chips": 1}],
        "end_to_end": [{"name": "setup_s"},
                       {"name": "only_elsewhere", "workloads": ["other"]}],
        "per_layer": [{"name": "new_metric.layer", "workloads": ["new.cell"]}],
    }
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(registry, "ROOT", tmp_path)
    monkeypatch.setattr(registry, "HERE", here)
    b = registry.benchmark()
    cell = registry.cell(b, "new.cell")
    assert registry.config(b, cell["config"]) == {"x": 1}
    assert registry.traffic(cell["traffic"]) == CLOSED
    assert [m["name"] for m in registry.metrics(b, "new.cell", False)] == [
        "setup_s"]
    names = [m["name"] for m in registry.metrics(b, "new.cell", True)]
    assert names == ["new_metric.layer"]
    assert registry.reader("new_metric.layer")(None) == 42.0
    with pytest.raises(KeyError):
        registry.cell(b, "missing")


def test_every_metric_and_cell_of_the_benchmark_has_its_files():
    bench = registry.benchmark(held=True)
    names = {w["name"] for w in bench["workloads"]}
    assert "stack.l10.saturate" in names and "elastic.l30.sine" in names
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", names)) <= names
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(registry.reader(m["name"]))
    for wl in bench["workloads"]:
        cfg = registry.config(bench, wl["config"])
        mix = registry.traffic(wl["traffic"])
        assert registry.reference(cfg["reference"]).make_catalog
        assert mix["loop"] in ("closed", "open")
        e2e = [m["name"] for m in registry.metrics(bench, wl["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert registry.metrics(bench, wl["name"], True)
