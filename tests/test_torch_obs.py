"""The port's lifecycle observability against the JAX package's: the
recorder, the event stream the simulator emits (every event, its kind, task,
executor, simulated time and fields), the runtime's lifecycle fingerprints
under batch-synchronous replay, the free-when-off contract, Chrome-trace
export, the sim-twin divergence diff, and the quickstart's fourth stanza --
all exactly the reference's."""
import contextlib
import dataclasses
import importlib.util
import io
import json
import random
from pathlib import Path

import pytest

import repro_torch.experiments as pt_exp
from repro import experiments as jax_exp
from repro import obs as jobs
from repro import workloads as jw
from repro.core import DataObject as JaxDataObject
from repro_torch import obs as pobs
from repro_torch import workloads as pw
from repro_torch.apps import quickstart
from repro_torch.core.objects import DataObject
from repro_torch.experiments import (CacheSpec, ClusterSpec, ExperimentSpec,
                                     ObserveSpec, ProvisionerSpec,
                                     RuntimeEngine, SimEngine, WorkloadSpec)

ROOT = Path(__file__).resolve().parents[1]
MB = 10**6


def _jax(spec: ExperimentSpec):
    return jax_exp.ExperimentSpec.from_dict(spec.to_dict())


# --------------------------------------------------------------------------
# recorder
# --------------------------------------------------------------------------

def _emit_script(rec) -> None:
    rec.emit("task_arrived", tid="t0")
    rec.emit("pool", t=9.0, eid="w0", size=1, delta=1)
    for i in range(6):
        rec.emit("pump", n=i, queue=6 - i)


@pytest.mark.parametrize("capacity", [1, 3, 8, 64])
def test_recorder_ring_and_sink_match_the_reference(capacity, tmp_path):
    got = pobs.Recorder(capacity=capacity, clock=lambda: 1.5)
    want = jobs.Recorder(capacity=capacity, clock=lambda: 1.5)
    _emit_script(got)
    _emit_script(want)
    assert got.events() == want.events()
    assert (got.emitted, got.dropped, len(got)) \
        == (want.emitted, want.dropped, len(want))
    got.dump(tmp_path / "pt.jsonl")
    want.dump(tmp_path / "jax.jsonl")
    assert (tmp_path / "pt.jsonl").read_text() \
        == (tmp_path / "jax.jsonl").read_text()
    # each package reads the other's sink
    assert pobs.load_events(tmp_path / "jax.jsonl") \
        == jobs.load_events(tmp_path / "pt.jsonl")
    drained = got.drain()
    assert len(got) == 0
    got.ingest(drained)
    assert got.events() == want.events()


def test_recorder_refuses_like_the_reference(tmp_path):
    for pkg in (pobs, jobs):
        with pytest.raises(ValueError, match=">= 1"):
            pkg.Recorder(capacity=0)
    rec = pobs.Recorder(clock=lambda: 0.0)
    rec.emit("pump", n=0)
    path = tmp_path / "e.jsonl"
    rec.dump(path)
    lines = path.read_text().splitlines()
    for text in (lines[0] + "\n",
                 json.dumps({"kind": "header", "version": 2}) + "\n",
                 lines[0] + "\n" + json.dumps({"kind": "nope", "t": 0}) + "\n"):
        path.write_text(text)
        with pytest.raises(ValueError) as want:
            jobs.load_events(path)
        with pytest.raises(ValueError) as got:
            pobs.load_events(path)
        assert str(got.value) == str(want.value)


def test_schema_matches_the_reference():
    assert pobs.EVENT_SCHEMA_VERSION == jobs.EVENT_SCHEMA_VERSION
    assert pobs.EVENT_KINDS == jobs.EVENT_KINDS
    assert pobs.LIFECYCLE_KINDS == jobs.LIFECYCLE_KINDS
    assert pobs.OUTCOME_FIELDS == jobs.OUTCOME_FIELDS
    for eid in ("e3", "w3", "host-2.w11", None, "oddball"):
        assert pobs.exec_index(eid) == jobs.exec_index(eid)


def test_outcome_record_matches_the_reference():
    class T:
        tid, executor, attempts = "t", "w0", 2
        submit_time, dispatch_time, start_time, end_time = (
            100.0, 101.0, 101.5, 103.5)
        bytes_local, bytes_cache_to_cache, bytes_store = 1, 2, 3
        cache_hits, peer_hits, cache_misses = 4, 5, 6

    for base in (0.0, 100.0):
        assert pobs.outcome_record(T(), base=base) \
            == jobs.outcome_record(T(), base=base)


# --------------------------------------------------------------------------
# ObserveSpec
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [
    {"ring_capacity": 0},
    {"sink_path": "/tmp/x.jsonl"},
    {"metrics": True, "metrics_interval_s": 0.0},
    {"metrics_sink_path": "/tmp/m.jsonl"},
    {"metrics_port": 0},
])
def test_observe_spec_refused_like_the_reference(bad):
    with pytest.raises(ValueError) as want:
        jax_exp.ObserveSpec(**bad)
    with pytest.raises(ValueError) as got:
        ObserveSpec(**bad)
    assert str(got.value) == str(want.value)


def test_observe_spec_round_trips_and_defaults_off():
    spec = ExperimentSpec(name="o", workload=_batch_wspec())
    assert spec.observe == ObserveSpec() and not spec.observe.events
    on = dataclasses.replace(spec, observe=ObserveSpec(
        events=True, ring_capacity=128, metrics=True,
        metrics_interval_s=0.1))
    assert ExperimentSpec.from_dict(on.to_dict()) == on
    assert _jax(on).to_dict()["observe"] == on.to_dict()["observe"]
    d = spec.to_dict()
    d["observe"] = {"events": True, "ringcap": 9}
    with pytest.raises(ValueError, match="ringcap"):
        ExperimentSpec.from_dict(d)


# --------------------------------------------------------------------------
# the simulator's event stream, event for event
# --------------------------------------------------------------------------

def _batch_wspec(n_tasks=40):
    return WorkloadSpec(
        name="par",
        arrivals={"kind": "BatchArrivals", "at_s": 0.0},
        popularity={"kind": "ZipfPopularity", "alpha": 1.1, "k": 2,
                    "corr": 1.0},
        n_tasks=n_tasks, n_objects=12, object_bytes=10_000, seed=7)


SIM_SPECS = {
    "batch-join": ExperimentSpec(
        name="obs", cluster=ClusterSpec(n_nodes=4), workload=_batch_wspec(),
        seed=3),
    "elastic-sine": ExperimentSpec(
        name="obs-elastic", cluster=ClusterSpec(n_nodes=1),
        cache=CacheSpec(capacity_bytes=50 * 10**9),
        provisioner=ProvisionerSpec(
            policy="exponential", min_executors=1, max_executors=8,
            queue_threshold=2, idle_timeout_s=4.0, trigger_cooldown_s=1.0),
        workload=WorkloadSpec(
            name="sine",
            arrivals={"kind": "SineWaveArrivals", "mean_rate": 8.0,
                      "amplitude": 7.5, "period_s": 30.0, "phase": 0.0},
            popularity={"kind": "ZipfPopularity", "alpha": 1.1, "k": 1,
                        "corr": 1.0},
            n_tasks=240, n_objects=40, object_bytes=20 * MB,
            object_prefix="f", compute_seconds=0.5, seed=1),
        seed=0),
    "dag": ExperimentSpec(
        name="obs-dag", cluster=ClusterSpec(n_nodes=3),
        workload=WorkloadSpec(name="pyr", dag={
            "kind": "stacking_pyramid", "n_groups": 3, "group_size": 3,
            "object_bytes": MB, "stack_bytes": MB // 4}),
        seed=1),
    "first-available-lru": ExperimentSpec(
        name="obs-fa", cluster=ClusterSpec(n_nodes=4),
        cache=CacheSpec(capacity_bytes=50_000),
        policy="first-available", workload=_batch_wspec(60), seed=5),
    "sessions": ExperimentSpec(
        name="obs-sess", cluster=ClusterSpec(n_nodes=4),
        workload=WorkloadSpec(name="s", sessions={
            "kind": "chat", "n_sessions": 16, "turns_per_session": 3,
            "kv_bytes_per_token": 256, "block": 16}),
        seed=2),
}


def _sim_run(pkg_exp, spec):
    eng = pkg_exp.SimEngine()
    try:
        eng.prepare(spec)
        rep = eng.run()
        return rep, eng.recorder.events(), eng.last_outcomes
    finally:
        eng.shutdown()


@pytest.mark.parametrize("name", sorted(SIM_SPECS))
def test_sim_event_stream_equals_the_reference(name):
    spec = dataclasses.replace(SIM_SPECS[name],
                               observe=ObserveSpec(events=True))
    rep, events, outcomes = _sim_run(pt_exp, spec)
    jrep, jevents, joutcomes = _sim_run(jax_exp, _jax(spec))
    assert len(events) > 0
    assert events == jevents          # kinds, tids, eids, sim times, fields
    assert outcomes == joutcomes
    assert rep.diff(jrep, ignore=("spec_sha", "wall_s")) == {}
    assert rep.telemetry == jrep.telemetry == {"recorder_dropped": 0}
    assert pobs.lifecycle_fingerprints(events) \
        == jobs.lifecycle_fingerprints(jevents)
    if name == "elastic-sine":
        assert {"provision", "pool"} <= {e["kind"] for e in events}
    if name == "dag":
        assert {"task_held", "task_ready"} <= {e["kind"] for e in events}


def test_sink_written_like_the_reference(tmp_path):
    spec = dataclasses.replace(SIM_SPECS["batch-join"], observe=ObserveSpec(
        events=True, sink_path=str(tmp_path / "pt.jsonl")))
    jspec = dataclasses.replace(_jax(spec), observe=jax_exp.ObserveSpec(
        events=True, sink_path=str(tmp_path / "jax.jsonl")))
    _sim_run(pt_exp, spec)
    _sim_run(jax_exp, jspec)
    assert (tmp_path / "pt.jsonl").read_text() \
        == (tmp_path / "jax.jsonl").read_text()
    header, events = pobs.load_events(tmp_path / "pt.jsonl")
    assert header["dropped"] == 0
    assert len(pobs.lifecycle_fingerprints(events)) == 40


# --------------------------------------------------------------------------
# runtime vs simulator under batch-synchronous replay
# --------------------------------------------------------------------------

def _serial_workload(pkg_object, pkg_workloads, n_tasks=40):
    """Arrivals 1 s apart vs ~0 service: every placement decision is made
    against an all-idle pool, the regime where engines agree exactly."""
    rng = random.Random(7)
    objs = [pkg_object(f"p.o{i}", 10_000) for i in range(12)]
    events = [pkg_workloads.TaskEvent(
        t=float(i), tid=f"p-{i}",
        inputs=tuple(o.oid for o in rng.sample(objs, 2)), outputs=(),
        compute_seconds=0.0, store_metadata_ops=0) for i in range(n_tasks)]
    return pkg_workloads.Workload("par", objs, events, spec=None)


def _serial_spec(**observe):
    return ExperimentSpec(
        name="obs-parity", cluster=ClusterSpec(testbed="anl_uc", n_nodes=4),
        policy="max-compute-util", workload=_batch_wspec(),
        observe=ObserveSpec(events=True, **observe), seed=3)


EXPECTED_KINDS = ("task_arrived", "task_queued", "task_dispatched",
                  "exec_start", "exec_end", "task_done")


@pytest.fixture(scope="module")
def serial_runs():
    """One observed serial replay on the port's simulator and runtime (on
    the CPU, shape-only), and on the reference's simulator and runtime."""
    runs = {}
    spec = _serial_spec()
    wl = _serial_workload(DataObject, pw)
    jwl = _serial_workload(JaxDataObject, jw)
    for label, eng, w in (("sim", SimEngine(), wl),
                          ("jax-sim", jax_exp.SimEngine(), jwl)):
        try:
            eng.prepare(spec if label == "sim" else _jax(spec), workload=w)
            rep = eng.run()
            runs[label] = (rep, eng.recorder.events(), eng.last_outcomes)
        finally:
            eng.shutdown()
    for label, eng, w in (("runtime", RuntimeEngine(device="cpu"), wl),
                          ("jax-runtime", jax_exp.RuntimeEngine(), jwl)):
        try:
            eng.prepare(spec if label == "runtime" else _jax(spec),
                        workload=w)
            rep = eng.run(barrier_every=1, timeout=120.0)
            runs[label] = (rep, eng.recorder.events(), eng.last_outcomes)
        finally:
            eng.shutdown()
    return runs


@pytest.mark.parametrize("label", ["sim", "runtime"])
def test_per_task_event_order(serial_runs, label):
    rep, events, outcomes = serial_runs[label]
    assert rep.n_completed == len(outcomes) == 40
    fps = pobs.lifecycle_fingerprints(events)
    assert len(fps) == 40
    for tid, (kinds, exec_idx, inputs) in fps.items():
        assert kinds == EXPECTED_KINDS, (tid, kinds)
        assert exec_idx is not None and len(inputs) == 2


@pytest.mark.parametrize("other", ["sim", "jax-sim", "jax-runtime"])
def test_runtime_fingerprints_equal(serial_runs, other):
    assert pobs.lifecycle_fingerprints(serial_runs["runtime"][1]) \
        == jobs.lifecycle_fingerprints(serial_runs[other][1])


def test_runtime_events_carry_the_references_fields(serial_runs):
    """Clock-free, the runtime's event stream -- pool events included -- is
    the reference runtime's, in order.  A pump's event is emitted outside
    the runtime lock, so where it lands beside the next arrival is a race:
    the pump events are held as a multiset."""
    def strip(evs, pumps):
        return [{k: v for k, v in e.items() if k != "t"} for e in evs
                if (e["kind"] == "pump") == pumps]
    got, want = serial_runs["runtime"][1], serial_runs["jax-runtime"][1]
    assert strip(got, False) == strip(want, False)
    key = lambda e: sorted(e.items())  # noqa: E731
    assert sorted(strip(got, True), key=key) \
        == sorted(strip(want, True), key=key)


@pytest.mark.parametrize("label", ["runtime", "jax-runtime"])
def test_divergence_diff_reports_full_agreement(serial_runs, label):
    predicted = serial_runs["sim"][2]
    div = pobs.diff_outcomes(serial_runs[label][2], predicted)
    assert div["n_matched"] == 40
    assert div["n_only_measured"] == div["n_only_predicted"] == 0
    assert div["placement_agreement"] == div["bytes_agreement"] == 1.0
    assert "placement agreement  100.0%" in pobs.format_divergence(div)
    jdiv = jobs.diff_outcomes(serial_runs[label][2], predicted)
    assert pobs.format_divergence(div, latencies=False) \
        == jobs.format_divergence(jdiv, latencies=False)
    assert div == jdiv


def test_trace_v3_diff_loop_end_to_end(serial_runs, tmp_path):
    """record_v3(runtime outcomes) -> sim_replay_outcomes(twin spec) ->
    diff, and the reference's twin predicts the same outcomes."""
    wl = _serial_workload(DataObject, pw)
    measured = serial_runs["runtime"][2]
    trace = tmp_path / "rt.jsonl"
    pw.record_v3(wl, trace, measured)
    spec = _serial_spec()
    predicted = pobs.sim_replay_outcomes(spec, trace_path=str(trace))
    assert predicted == jobs.sim_replay_outcomes(_jax(spec),
                                                 trace_path=str(trace))
    div = pobs.diff_outcomes(measured, predicted)
    assert div["placement_agreement"] == 1.0
    assert div["latency_error_s"]["queue_s"]["n"] == 40


def test_sim_twin_spec_strips_observe_and_coherence():
    spec = dataclasses.replace(_serial_spec(), index_update_batch=4)
    twin = pobs.sim_twin_spec(spec, trace_path="x.jsonl")
    assert not twin.observe.events and twin.index_update_batch == 1
    assert twin.workload == WorkloadSpec(name="par", trace_path="x.jsonl")
    assert twin.cluster == spec.cluster and twin.seed == spec.seed
    jtwin = jobs.sim_twin_spec(_jax(spec), trace_path="x.jsonl")
    assert twin.to_dict() == jtwin.to_dict()
    # a fleet spec's twin is the in-process layout, as the reference's
    fleet = dataclasses.replace(spec, hosts=2, threads_per_host=2,
                                wire_batch=8, local_dispatch=True)
    assert pobs.sim_twin_spec(fleet).to_dict() \
        == jobs.sim_twin_spec(_jax(fleet)).to_dict()


# --------------------------------------------------------------------------
# free when off
# --------------------------------------------------------------------------

#: scheduling-determined report fields: identical between two runs of one
#: spec under batch-synchronous replay, whatever the wall clock did
SCHED_FIELDS = ("n_tasks", "n_completed", "n_failed", "local_hits",
                "peer_hits", "store_reads", "local_hit_ratio",
                "cache_hit_ratio", "full_hit_tasks", "partial_hit_tasks",
                "zero_hit_tasks", "bytes_by_kind", "mean_inputs_per_task",
                "peak_executors")


@pytest.mark.parametrize("engine", ["sim", "runtime"])
def test_events_off_runs_identically_and_without_recorder(engine):
    reps = {}
    for label in ("off", "on"):
        spec = _serial_spec()
        if label == "off":
            spec = ExperimentSpec.from_dict({**spec.to_dict(),
                                             "observe": {"events": False}})
        eng = SimEngine() if engine == "sim" else RuntimeEngine(device="cpu")
        try:
            eng.prepare(spec, workload=_serial_workload(DataObject, pw, 10))
            if engine == "sim":
                reps[label] = eng.run()
            else:
                reps[label] = eng.run(barrier_every=1, timeout=60.0)
            if label == "off":
                assert eng.recorder is None       # no ring allocated at all
                hooks = (eng.sim if engine == "sim" else eng.runtime)
                assert hooks.recorder is None
                assert hooks.dispatcher.recorder is None
        finally:
            eng.shutdown()
    assert reps["off"].telemetry == {}
    assert reps["on"].telemetry == {"recorder_dropped": 0}
    if engine == "sim":           # recording changed no metric
        assert reps["off"].diff(reps["on"]) == {}
    for f in SCHED_FIELDS:        # the runtime's clock fields are wall time
        assert getattr(reps["off"], f) == getattr(reps["on"], f), f


# --------------------------------------------------------------------------
# Chrome-trace export
# --------------------------------------------------------------------------

GOLDEN_EVENTS = [
    {"t": 10.0, "kind": "pool", "eid": "w0", "size": 1, "delta": 1},
    {"t": 10.0, "kind": "pool", "eid": "w1", "size": 2, "delta": 1},
    {"t": 10.5, "kind": "task_arrived", "tid": "a"},
    {"t": 10.5, "kind": "pump", "bound": 1, "queue": 0},
    {"t": 10.5, "kind": "input", "tid": "a", "eid": "w1", "oid": "o1",
     "source": "store", "bytes": 100},
    {"t": 10.6, "kind": "exec_start", "tid": "a", "eid": "w1"},
    {"t": 10.8, "kind": "exec_end", "tid": "a", "eid": "w1", "ok": True},
    {"t": 11.0, "kind": "input", "tid": "b", "eid": "w0", "oid": "o1",
     "source": "peer", "peer": "w1", "bytes": 100},
    {"t": 11.1, "kind": "exec_start", "tid": "b", "eid": "w0"},
    {"t": 11.2, "kind": "exec_end", "tid": "b", "eid": "w0", "ok": True},
]
GOLDEN_SAMPLES = [
    {"kind": "metrics", "t": 10.4,
     "metrics": {"counters": {}, "histograms": {},
                 "gauges": {"sched.queue_depth": 3, "pool.size": 2,
                            "cache.bytes": 50}}},
    {"kind": "metrics", "t": 11.4,
     "metrics": {"counters": {}, "histograms": {},
                 "gauges": {"sched.queue_depth": 0, "pool.size": 2}},
     "hosts": {"h1": {"metrics": {"gauges": {"cache.bytes": 90}}},
               "h0": {"metrics": {"gauges": {"cache.bytes": 110}}}}},
]


@pytest.mark.parametrize("case", ["events", "events+samples", "samples"])
def test_chrome_trace_golden_equals_the_reference(case, tmp_path):
    events = [] if case == "samples" else GOLDEN_EVENTS
    samples = None if case == "events" else GOLDEN_SAMPLES
    got = pobs.chrome_trace(events, tmp_path / "pt.json", samples=samples)
    want = jobs.chrome_trace(events, tmp_path / "jax.json", samples=samples)
    assert got == want
    assert (tmp_path / "pt.json").read_text() \
        == (tmp_path / "jax.json").read_text()
    assert got["displayTimeUnit"] == "ms"


@pytest.mark.parametrize("name", ["batch-join", "dag", "elastic-sine"])
def test_chrome_trace_of_a_sim_run_equals_the_reference(name):
    spec = dataclasses.replace(SIM_SPECS[name],
                               observe=ObserveSpec(events=True))
    _, events, _ = _sim_run(pt_exp, spec)
    _, jevents, _ = _sim_run(jax_exp, _jax(spec))
    got = pobs.chrome_trace(events)
    assert got == jobs.chrome_trace(jevents)
    spans = [e for e in got["traceEvents"] if e["ph"] == "X"]
    assert spans and all(s["dur"] >= 0 and s["ts"] >= 0 for s in spans)


def test_chrome_trace_of_a_runtime_run_is_valid(serial_runs):
    rep, events, _ = serial_runs["runtime"]
    out = pobs.chrome_trace(events)
    all_spans = [e for e in out["traceEvents"] if e["ph"] == "X"]
    spans = [e for e in all_spans if e["cat"] == "task"]
    assert len(spans) == rep.n_completed == 40
    assert len([e for e in all_spans if e["cat"] == "queue_wait"]) == 40
    assert not [e for e in all_spans if e["cat"] == "dep_wait"]
    # one track per executor that any event names (the pool events name
    # all four), as the reference runtime's trace has
    names = {e["args"]["name"] for e in out["traceEvents"] if e["ph"] == "M"}
    assert {s["args"]["executor"] for s in spans} <= names
    want = jobs.chrome_trace(serial_runs["jax-runtime"][1])
    assert names == {e["args"]["name"] for e in want["traceEvents"]
                     if e["ph"] == "M"} == {"w0", "w1", "w2", "w3",
                                            "dep_wait", "queue_wait"}
    # the same records; a pump's event may land either side of the next
    # arrival (it is emitted outside the runtime lock), so compare them as
    # a multiset
    assert sorted((e["ph"], e.get("name"), e.get("tid"))
                  for e in out["traceEvents"]) \
        == sorted((e["ph"], e.get("name"), e.get("tid"))
                  for e in want["traceEvents"])


# --------------------------------------------------------------------------
# the quickstart's fourth stanza
# --------------------------------------------------------------------------

def _stdout(fn) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().splitlines()


def test_quickstart_observed_stanza_prints_the_reference_lines(
        monkeypatch, tmp_path):
    spec = importlib.util.spec_from_file_location(
        "quickstart_example", ROOT / "examples" / "quickstart.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    monkeypatch.chdir(tmp_path)
    want = _stdout(ref.observed)
    want_trace = json.loads((tmp_path / "quickstart_trace.json").read_text())
    (tmp_path / "quickstart_trace.json").unlink()
    got = _stdout(quickstart.observed)
    assert got == want
    assert got[0].startswith("== observed")
    assert json.loads((tmp_path / "quickstart_trace.json").read_text()) \
        == want_trace
