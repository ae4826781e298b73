"""Whole runs of both cells on the CPU, cut to a tiny size: a sound run is
correct, and each fault planted under the timed path, and the reference
computed in bfloat16 in the program's place, makes ``correct`` false.

These skip the harness's look for a card (``run.measure`` is what
``run.main`` calls once it has found one) and run the program on the CPU.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from ddbench import registry, run
from ddbench.conftest import seconds_of
from repro_torch.apps import astro
from repro_torch.core import runtime
from repro_torch.core.scheduler import Dispatcher
from repro_torch.kernels.stacking import ops as st_ops

SEED = 2**32 + 11
CELLS = ["stack.l10.saturate", "elastic.l30.sine"]


def _measure(bench, cell, **kw):
    return run.measure(cell, SEED, seconds_of(bench, cell), False,
                       device="cpu", bench=bench, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct_and_reports_its_metrics(tiny_bench, cell):
    res = _measure(tiny_bench, cell)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    want = {m["name"] for m in registry.metrics(tiny_bench, cell, False)}
    assert set(res["metrics"]) == want
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["checks"]["coadd_rel_err"]["value"] < 1e-6
    json.dumps(res, allow_nan=False)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_its_per_layer_metrics(tiny_bench, cell):
    res = run.measure(cell, SEED, seconds_of(tiny_bench, cell), True,
                      device="cpu", bench=tiny_bench)
    assert res["correct"], res["checks"]
    # the device-trace metrics need the card; the rest read the program
    want = {m["name"] for m in registry.metrics(tiny_bench, cell, True)
            if m["source"] != "device_trace"}
    assert set(res["metrics"]) >= want


@pytest.mark.parametrize("cell", CELLS)
def test_only_a_traced_run_records(tiny_bench, cell):
    from ddbench import harness

    wl = registry.cell(tiny_bench, cell)
    cfg = registry.config(tiny_bench, wl["config"])
    mix = registry.traffic(wl["traffic"])
    ref = registry.reference(cfg["reference"])
    for trace in (False, True):
        run_ = harness.run_cell(cell, cfg, mix, ref, SEED,
                                seconds_of(tiny_bench, cell), trace, 0.0,
                                device="cpu")
        assert run_.trace is trace
        assert (run_.spans is not None) is trace
        assert run_.device is None          # the profiler needs the card


def test_a_run_waits_only_for_the_threads_it_started():
    from ddbench import harness

    stop = threading.Event()
    foreign = threading.Thread(target=stop.wait, daemon=True)
    foreign.start()
    try:
        before = set(threading.enumerate())
        mine = threading.Thread(target=time.sleep, args=(0.2,))
        mine.start()
        t0 = time.monotonic()
        assert harness._join_threads(before, timeout_s=5.0) == []
        assert time.monotonic() - t0 < 2.0 and not mine.is_alive()
    finally:
        stop.set()
        foreign.join(5.0)


def _altered(inputs):
    out = astro.stack_object(inputs).clone()
    out[50, 50] += 1.0
    return out


def _half_the_tiles(inputs):
    tiles = torch.cat(list(inputs.values()))
    tiles = tiles[:tiles.shape[0] // 2]
    ids = [int(o[3:]) for o in inputs]
    return st_ops.stack_rois(tiles, *astro.coadd_params(tiles, ids))


def _unchanged(inputs):
    return next(iter(inputs.values()))[0]


def _fails_some(inputs):
    # files 0-2 are in both tiny traces, and never among the warm-up's
    if any(int(o[3:]) < 3 for o in inputs):
        raise RuntimeError("planted failure")
    return astro.stack_object(inputs)


TASK_FAULTS = {
    "answer_altered": (_altered, "coadd_rel_err"),
    "half_the_batch": (_half_the_tiles, "coadd_rel_err"),
    "state_unchanged": (_unchanged, "coadd_rel_err"),
    "requests_fail": (_fails_some, "failed"),
}


@pytest.mark.parametrize("fault", sorted(TASK_FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_task_is_not_correct(tiny_bench, cell, fault):
    fn, check = TASK_FAULTS[fault]
    res = _measure(tiny_bench, cell, task_fn=fn)
    assert not res["correct"]
    c = res["checks"][check]
    assert c["value"] > c["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_bf16_control_is_not_correct(tiny_bench, cell):
    name = registry.cell(tiny_bench, cell)["config"]
    cfg = registry.config(tiny_bench, name)
    control = registry.reference(cfg["reference"]).control_task(cfg)
    res = _measure(tiny_bench, cell, task_fn=control)
    assert not res["correct"]
    assert res["checks"]["coadd_rel_err"]["value"] > 1e-3


def _stale_lookup(self, oid):
    """A cache that answers a hit with another file it holds."""
    with self.lock:
        if self.cache.get(oid):
            others = [o for o in self.payloads if o != oid]
            return self.payloads[others[0] if others else oid]
    return None


def _store_bytes_lost(self, t):
    t.bytes_local += self.bytes_local
    t.bytes_cache_to_cache += self.bytes_cache_to_cache
    t.cache_hits += self.cache_hits
    t.peer_hits += self.peer_hits
    t.cache_misses += self.cache_misses


_finished = Dispatcher.task_finished


def _one_never_completes(self, t, now, ok=True):
    if t.tid == "req-3":
        return None
    return _finished(self, t, now, ok)


def _grows_past_its_limit(self, n):
    for _ in range(n + 10):
        self.add_executor()


PROGRAM_FAULTS = {
    "stale_cache_entry": (runtime.CacheExecutorBase, "cache_lookup",
                          _stale_lookup, "coadd_rel_err"),
    "ledger_drops_store_bytes": (runtime._InputLedger, "merge_into",
                                 _store_bytes_lost, "ledger_mismatch"),
    "request_never_completes": (Dispatcher, "task_finished",
                                _one_never_completes, "unresolved"),
}


@pytest.mark.parametrize("fault", sorted(PROGRAM_FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_program_is_not_correct(tiny_bench, monkeypatch, cell,
                                         fault):
    owner, attr, broken, check = PROGRAM_FAULTS[fault]
    monkeypatch.setattr(owner, attr, broken)
    res = _measure(tiny_bench, cell)
    assert not res["correct"]
    c = res["checks"][check]
    assert c["value"] > c["limit"]


def test_a_pool_grown_past_its_limit_is_not_correct(tiny_bench, monkeypatch):
    monkeypatch.setattr(runtime.DiffusionRuntime, "provision_grow",
                        _grows_past_its_limit)
    res = _measure(tiny_bench, "elastic.l30.sine")
    assert not res["correct"]
    assert res["checks"]["pool_out_of_bounds"]["value"] > 0


def test_without_a_card_the_command_fails_and_prints_no_result(tmp_path):
    root = Path(__file__).resolve().parents[1]
    shutil.copytree(root / "ddbench", tmp_path / "ddbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "BENCHMARK.json").write_text(
        (root / "BENCHMARK.json").read_text())
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(
        [sys.executable, "ddbench/run.py", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout == ""
