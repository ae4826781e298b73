"""The port's experiment layer against the JAX package's: spec behaviour
(JSON round trips, dotted overrides, the alias map, knobs each engine
refuses), seed-paired sweeps, the quickstart's stdout, and the threaded
runtime's elasticity on the CPU -- an elastic pool driven by the
provisioner, and released executors giving their cached tensors back."""
import contextlib
import dataclasses
import importlib.util
import io
import json
import time
import weakref
from pathlib import Path

import pytest
import torch

from repro import experiments as jax_exp
from repro.experiments import spec as jax_spec_mod
from repro_torch import convert
from repro_torch.apps import astro, quickstart
from repro_torch.core.objects import DataObject
from repro_torch.core.runtime import DiffusionRuntime
from repro_torch.experiments import (ALIASES, CacheSpec, ClusterSpec, Engine,
                                     ExperimentSpec, ProvisionerSpec,
                                     RuntimeEngine, SimEngine, Sweep,
                                     WorkloadSpec, engine_names, load_results,
                                     make_engine, run_experiment,
                                     with_overrides)
from repro_torch.experiments import spec as spec_mod

ROOT = Path(__file__).resolve().parents[1]
MB = 10**6

BASE = ExperimentSpec(
    name="base",
    workload=WorkloadSpec(
        name="zipf",
        arrivals={"kind": "PoissonArrivals", "rate_per_s": 30.0},
        popularity={"kind": "ZipfPopularity", "alpha": 1.1, "k": 1,
                    "corr": 1.0},
        n_tasks=200, n_objects=30, object_bytes=10 * MB,
        object_prefix="f", compute_seconds=0.1, seed=0),
    cluster=ClusterSpec(n_nodes=4),
    provisioner=ProvisionerSpec(policy="additive", additive_k=2,
                                max_executors=8, idle_timeout_s=2.0),
    seed=0)


def _reference_dict(spec) -> dict:
    """A reference spec's dict: the port's spec has every field it has."""
    return spec.to_dict()


def _jax(spec: ExperimentSpec):
    return jax_exp.ExperimentSpec.from_dict(spec.to_dict())


# --------------------------------------------------------------------------
# spec behaviour
# --------------------------------------------------------------------------

def test_spec_json_round_trips(tmp_path):
    spec = dataclasses.replace(
        BASE, write_outputs_to="store", index_update_interval_s=0.5,
        release_policy="rebalance", flow_solver="naive",
        speculation_factor=1.5)
    assert ExperimentSpec.from_json(spec.to_json()) == spec
    path = tmp_path / "spec.json"
    spec.save(path)
    assert ExperimentSpec.load(path) == spec
    with path.open() as f:
        assert ExperimentSpec.load(f) == spec
    assert ExperimentSpec.from_dict(spec.to_dict()).fingerprint() \
        == spec.fingerprint()
    # the reference reads what the port writes, and writes it back the same
    assert _reference_dict(_jax(spec)) == spec.to_dict()


def test_spec_defaults_match_reference():
    want = _reference_dict(jax_exp.ExperimentSpec(
        name="d", workload=jax_exp.WorkloadSpec(**BASE.workload.__dict__)))
    assert ExperimentSpec(name="d", workload=BASE.workload).to_dict() == want
    assert dataclasses.asdict(ProvisionerSpec()) \
        == dataclasses.asdict(jax_exp.ProvisionerSpec())


@pytest.mark.parametrize("bad", [
    {"policy": "fastest"}, {"write_outputs_to": "disk"},
    {"release_policy": "migrate"}, {"flow_solver": "maxmin"},
    {"index_update_batch": 0},
    {"provisioner": {"policy": "random"}},
    {"provisioner": {"min_executors": 9, "max_executors": 8}},
    {"provisioner": {"period_s": 0.0}},
    {"provisioner": {"trigger_cooldown_s": -1.0}},
    {"provisioner": {"idle": 1.0}},
])
def test_invalid_specs_are_refused_like_the_reference(bad):
    d = {**BASE.to_dict(), **bad}
    with pytest.raises(ValueError) as want:
        jax_exp.ExperimentSpec.from_dict(d)
    with pytest.raises(ValueError) as got:
        ExperimentSpec.from_dict(d)
    assert str(got.value) == str(want.value)


OVERRIDES = [
    {"policy": "first-available", "cache.capacity_bytes": 0},
    {"provisioner.policy": "exponential", "provisioner.period_s": 0.5},
    {"provisioner": {"policy": "one-at-a-time", "max_executors": 4}},
    {"workload.arrivals.rate_per_s": 5.0, "seed": 3},
    {"workload.arrivals": {"kind": "BatchArrivals", "at_s": 0.0}},
    {"release_policy": "rebalance", "speculation_factor": 2.0},
]


@pytest.mark.parametrize("overrides", OVERRIDES)
def test_with_overrides_matches_reference(overrides):
    got = with_overrides(BASE, overrides)
    want = jax_exp.with_overrides(_jax(BASE), overrides)
    assert got.to_dict() == _reference_dict(want)
    assert BASE.policy == "max-compute-util"    # the base is untouched


@pytest.mark.parametrize("overrides", [
    {"policy.x": 1}, {"cluster.nodes": 3}, {"workload.arrivals.rate": 1.0},
    {"a..b": 1}, {"provisioner.policy": "random"},
])
def test_bad_overrides_are_refused_like_the_reference(overrides):
    with pytest.raises(ValueError) as want:
        jax_exp.with_overrides(_jax(BASE), overrides)
    with pytest.raises(ValueError) as got:
        with_overrides(BASE, overrides)
    assert str(got.value) == str(want.value)


def test_override_into_an_unset_provisioner_is_refused():
    with pytest.raises(ValueError, match="None in the base spec"):
        with_overrides(dataclasses.replace(BASE, provisioner=None),
                       {"provisioner.policy": "exponential"})


def test_alias_map_matches_reference_and_live_signatures(monkeypatch):
    spec_mod.check_alias_map()
    assert ALIASES == jax_exp.ALIASES
    assert spec_mod.FLEET_PATHS == jax_spec_mod.FLEET_PATHS
    assert spec_mod.FLEET_OPERATIONAL_KWARGS \
        == jax_spec_mod.FLEET_OPERATIONAL_KWARGS
    assert spec_mod.DOCUMENTED_DIVERGENCES == jax_exp.DOCUMENTED_DIVERGENCES
    # drift is caught: a renamed engine knob, a stale divergence entry
    monkeypatch.setattr(spec_mod, "_alias_map_checked", False)
    monkeypatch.setitem(spec_mod.ALIASES, "flow_solver",
                        ("flow_model", None))
    with pytest.raises(RuntimeError, match="SimConfig has no field"):
        spec_mod.check_alias_map()
    monkeypatch.setitem(spec_mod.ALIASES, "flow_solver",
                        ("flow_solver", None))
    monkeypatch.setitem(spec_mod.DOCUMENTED_DIVERGENCES,
                        "cache.capacity_bytes", {"sim": 1, "runtime": 2})
    with pytest.raises(RuntimeError, match="stale"):
        spec_mod.check_alias_map()


SIM_ONLY = [("cluster", ClusterSpec(n_nodes=2, cpus_per_node=2)),
            ("write_outputs_to", "store"), ("index_update_interval_s", 0.5),
            ("release_policy", "rebalance"), ("flow_solver", "naive"),
            ("speculation_factor", 1.0)]


@pytest.mark.parametrize("field,value", SIM_ONLY,
                         ids=[f for f, _ in SIM_ONLY])
def test_runtime_refuses_sim_only_knobs(field, value):
    spec = dataclasses.replace(BASE, **{field: value})
    with pytest.raises(ValueError, match="runtime engine does not support"):
        RuntimeEngine(device="cpu").prepare(spec)


def test_sim_refuses_runtime_only_knob():
    with pytest.raises(ValueError, match="sim engine does not support"):
        SimEngine().prepare(dataclasses.replace(BASE, index_update_batch=4))


def test_spec_from_json_takes_provisioner_and_sim_knobs(tmp_path):
    spec = dataclasses.replace(BASE, release_policy="rebalance",
                               speculation_factor=2.0,
                               write_outputs_to="none")
    path = tmp_path / "spec.json"
    _jax(spec).save(path)
    assert convert.spec_from_json(path) == spec


def test_engine_registry():
    assert engine_names() == ["runtime", "serve", "sim"]
    assert engine_names() == jax_exp.engine_names()
    assert isinstance(make_engine("sim"), SimEngine)
    assert isinstance(make_engine("runtime"), RuntimeEngine)
    assert isinstance(make_engine("serve"), RuntimeEngine)
    assert isinstance(SimEngine(), Engine)
    assert isinstance(RuntimeEngine(device="cpu"), Engine)
    with pytest.raises(ValueError, match="unknown engine"):
        make_engine("fleet")


def test_run_experiment_equals_reference_on_the_simulator():
    got = run_experiment(BASE, engine="sim")
    want = jax_exp.run_experiment(_jax(BASE), engine="sim")
    assert got.diff(want, ignore=("spec_sha", "wall_s")) == {}
    assert got.n_allocated == want.n_allocated


# --------------------------------------------------------------------------
# sweeps
# --------------------------------------------------------------------------

GRID = {"policy": ["first-available", "max-compute-util"],
        "provisioner.policy": ["one-at-a-time", "exponential"]}


def test_sweep_results_match_reference(tmp_path):
    ran = Sweep(BASE, GRID, seeds=[0, 1]).run(out_dir=tmp_path / "pt")
    jax_exp.Sweep(_jax(BASE), GRID, seeds=[0, 1]).run(
        out_dir=tmp_path / "jax")
    lines = {}
    for pkg in ("pt", "jax"):
        lines[pkg] = [json.loads(ln) for ln in
                      (tmp_path / pkg / "results.jsonl").read_text()
                      .splitlines()]
        for rec in lines[pkg]:
            for k in ("spec_sha", "wall_s"):
                rec["report"].pop(k)
    assert len(lines["pt"]) == 8
    assert lines["pt"] == lines["jax"]
    assert [rec["overrides"] for rec in lines["pt"]][-1] == {
        "policy": "max-compute-util", "provisioner.policy": "exponential",
        "seed": 1, "workload.seed": 1}
    manifest = json.loads((tmp_path / "pt" / "manifest.json").read_text())
    assert manifest["n_cells"] == 8 and manifest["seeds"] == [0, 1]
    back = load_results(tmp_path / "pt")
    assert [rep for _, rep in back] == [rep for _, rep in ran]
    assert [rec["index"] for rec, _ in back] == list(range(8))


def test_sweep_refuses_a_seed_axis_in_the_grid():
    with pytest.raises(ValueError, match="seed-paired"):
        Sweep(BASE, {"workload.seed": [0, 1]})


# --------------------------------------------------------------------------
# the quickstart
# --------------------------------------------------------------------------

def _stdout(fn) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().splitlines()


def test_quickstart_prints_the_reference_stanzas_1_to_3(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "quickstart_example", ROOT / "examples" / "quickstart.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    # stanza 4 (lifecycle recording) has its own test in test_torch_obs.py
    monkeypatch.setattr(ref, "observed", lambda: None)
    monkeypatch.setattr(quickstart, "observed", lambda: None)
    want = _stdout(ref.main)
    got = _stdout(quickstart.main)
    assert got == want
    assert sum(ln.startswith("== ") for ln in got) == 3


# --------------------------------------------------------------------------
# the threaded runtime's elasticity, on the CPU
# --------------------------------------------------------------------------

def test_allocates_under_queue_pressure():
    spec = ExperimentSpec(
        name="rt-elastic",
        cluster=ClusterSpec(n_nodes=1),
        cache=CacheSpec(capacity_bytes=10**9),
        policy="max-compute-util",
        provisioner=ProvisionerSpec(
            policy="exponential", min_executors=1, max_executors=4,
            queue_threshold=1, idle_timeout_s=60.0,
            trigger_cooldown_s=0.0, period_s=0.02),
        workload=WorkloadSpec(
            name="burst",
            arrivals={"kind": "BatchArrivals", "at_s": 0.0},
            popularity={"kind": "UniformScan", "stride": 1, "k": 1},
            n_tasks=60, n_objects=16, object_bytes=MB, seed=0),
        seed=0)

    def slow_task(inputs):
        time.sleep(0.01)
        return 0

    eng = RuntimeEngine(device="cpu").prepare(spec)
    try:
        rep = eng.run(task_fn=slow_task, time_scale=0.0, timeout=60.0)
    finally:
        eng.shutdown()
    assert rep.n_completed == 60
    assert rep.n_allocated > 0           # the DRP grew the pool
    assert rep.peak_executors > 1
    assert rep.peak_executors <= 4       # ...but respected max
    assert eng.provision_failures == []


#: a sine wave over two 3 s periods that one executor cannot serve at its
#: peak (each request holds its executor for the paper's 42 ms of host
#: time before the coadd) and that leaves the pool idle in its trough
SINE_PERIOD = 3.0
SINE = {"kind": "SineWaveArrivals", "mean_rate": 100.0, "amplitude": 95.0,
        "period_s": SINE_PERIOD, "phase": 0.0}
SINE_PROVISIONER = ProvisionerSpec(
    policy="exponential", min_executors=1, max_executors=8,
    queue_threshold=2, idle_timeout_s=0.5, trigger_cooldown_s=0.25,
    period_s=0.25)


def test_sine_wave_pool_rises_and_falls_through_stacking():
    torch.set_num_threads(1)
    spec = astro.elastic_spec(600, 40, SINE, SINE_PROVISIONER)
    eng = RuntimeEngine(device="cpu").prepare(spec)
    try:
        rep = eng.run(task_fn=astro.decode_and_stack,
                      payload_factory=astro.make_tiles,
                      time_scale=1.0, timeout=120.0)
        results = [t.result for t in eng.runtime.dispatcher.completed]
    finally:
        eng.shutdown()
    assert rep.n_completed == 600 and rep.n_failed == 0
    assert all(tuple(r.shape) == (100, 100) for r in results)
    assert rep.n_allocated > 0 and rep.n_released > 0
    shape = astro.pool_shape(list(rep.pool_log), SINE_PERIOD)
    assert shape["grew"] == [True, True] and shape["shrank"], rep.pool_log
    assert 1 < shape["peak"] <= 8
    assert eng.provision_failures == []


def test_removed_executor_frees_the_tensors_only_it_cached():
    """A tensor only the removed executor cached is freed when
    ``remove_executor`` returns, even while something still holds the
    executor object; one a surviving peer also caches stays alive."""
    rt = DiffusionRuntime(n_executors=2, seed=0, device="cpu")
    try:
        w0, w1 = rt.workers["w0"], rt.workers["w1"]
        own, shared = torch.arange(1000.0), torch.ones(500)
        w0.cache_admit(DataObject("own", 4000), own)
        w0.cache_admit(DataObject("shared", 2000), shared)
        w1.cache_admit(DataObject("shared", 2000), shared)
        # only w0 holds ``own``: its storage is what removing w0 frees
        assert rt.exclusive_cache_bytes(["w0"]) == 4000
        assert rt.exclusive_cache_bytes(["w0", "w1"]) == 6000
        own_ref, shared_ref = weakref.ref(own), weakref.ref(shared)
        del own, shared
        rt.remove_executor("w0")
        assert own_ref() is None
        assert shared_ref() is not None
        assert w1.payloads["shared"] is shared_ref()
        assert "w0" not in rt.workers and w0.payloads == {}
        assert rt.exclusive_cache_bytes(["w1"]) == 2000   # now w1 alone
        # an attempt still running on the released executor admits nothing
        w0.cache_admit(DataObject("late", 8), torch.zeros(2))
        assert w0.payloads == {} and "late" not in w0.cache
    finally:
        rt.shutdown()


def test_provision_hooks_grow_release_and_report_idle():
    rt = DiffusionRuntime(n_executors=1, seed=0, device="cpu")
    try:
        rt.provision_grow(3)
        assert sorted(rt.workers) == ["w0", "w1", "w2", "w3"]
        with rt._lock:
            idle = rt.provision_idle(time.monotonic(), 0.0)
        assert sorted(idle) == ["w0", "w1", "w2", "w3"]
        rt.provision_release(idle[1:])
        assert len(rt.workers) == 1
        assert [n for _, n in rt.pool_log] == [1, 2, 3, 4, 3, 2, 1]
    finally:
        rt.shutdown()
