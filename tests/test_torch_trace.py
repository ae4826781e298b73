"""The port's trace record/replay against the JAX package's: the committed
v1 fixture replays to the reference's workload, and v2, v3 (with measured
outcomes) and v4 (DAG) traces written by either package are byte for byte
what the other writes and replay on the other to the same events, exactly.
A spec bound to a trace (``WorkloadSpec.trace_path``) runs on the port's
simulator to the reference's report, and ``convert.spec_from_json`` takes a
reference spec that binds a trace, a sessions recipe or events on."""
import dataclasses
import io
import json
from pathlib import Path

import pytest

from repro import experiments as jax_exp
from repro import workloads as jw
from repro_torch import convert
from repro_torch import workloads as pw
from repro_torch.experiments import (ExperimentSpec, ObserveSpec, SimEngine,
                                     WorkloadSpec, build_workload,
                                     run_experiment)

ROOT = Path(__file__).resolve().parents[1]
V1 = ROOT / "tests" / "data" / "trace_v1.jsonl"
MB = 10**6

#: (arrival process, popularity model) pairs, as constructor arguments
GENERATORS = [
    ("BatchArrivals", {}, "UniformScan", {}),
    ("PoissonArrivals", {"rate_per_s": 6.0}, "ZipfPopularity",
     {"alpha": 1.0, "k": 2, "corr": 0.5}),
    ("SineWaveArrivals", {"mean_rate": 5.0, "amplitude": 4.0,
                          "period_s": 40.0},
     "ShiftingWorkingSet", {"working_set": 5, "shift_every": 20,
                            "shift_by": 3}),
    ("DiurnalArrivals", {"peak_rate": 12.0, "trough_rate": 1.0,
                         "day_s": 120.0},
     "StackingTrace", {"locality": 4, "shuffle_seed": 9}),
]
GEN_IDS = [f"{a}-{p}" for a, _, p, _ in GENERATORS]


def _generate(pkg, case):
    arr, akw, pop, pkw = case
    return pkg.generate("rt", pkg.ARRIVALS[arr](**akw),
                        pkg.POPULARITY[pop](**pkw), n_tasks=90,
                        n_objects=15, object_bytes=3 * MB,
                        compute_seconds=0.02, output_bytes=MB,
                        store_metadata_ops=1, seed=13)


def _dag(pkg):
    return pkg.build_dag({"kind": "stacking_pyramid", "n_groups": 3,
                          "group_size": 3, "object_bytes": MB,
                          "stack_bytes": MB // 4}, name="pyr")


def _fp(wl) -> tuple:
    """A workload's full identity as plain values (the two packages'
    DataObject and TaskEvent classes differ)."""
    return (wl.name, wl.spec,
            tuple((o.oid, o.size_bytes) for o in wl.objects),
            tuple((e.t, e.tid, tuple(e.inputs), tuple(e.outputs),
                   e.compute_seconds, e.store_metadata_ops, tuple(e.deps))
                  for e in wl.events))


def _text(record, *args) -> str:
    buf = io.StringIO()
    record(*args[:1], buf, *args[1:])
    return buf.getvalue()


def _outcomes(wl) -> list[dict]:
    """Measured-looking outcome rows for every task of ``wl`` (every
    OUTCOME_FIELDS key plus the raw timestamps a real run also writes)."""
    rows = []
    for i, e in enumerate(wl.events):
        rows.append({"tid": e.tid, "executor": f"w{i % 3}", "attempts": 1,
                     "queue_s": 0.25 * i, "exec_s": 0.125, "turnaround_s":
                     0.25 * i + 0.125, "bytes_local": 0, "bytes_peer": MB,
                     "bytes_store": 2 * MB, "cache_hits": 0, "peer_hits": 1,
                     "cache_misses": 2, "t_submit": e.t, "t_dispatch": e.t,
                     "t_start": e.t, "t_end": e.t + 0.5})
    return rows


# --------------------------------------------------------------------------
# the committed v1 fixture
# --------------------------------------------------------------------------

def test_v1_fixture_replays_to_the_reference_workload():
    got, want = pw.replay(V1), jw.replay(V1)
    assert _fp(got) == _fp(want)
    assert len(got) == 60
    # written back, it is a v2 trace, the same text in both packages
    assert _text(pw.record, got) == _text(jw.record, want)
    assert json.loads(_text(pw.record, got).splitlines()[0])["version"] == 2


def test_v1_fixture_runs_to_the_reference_report():
    spec = ExperimentSpec(name="v1", workload=WorkloadSpec(
        name="v1fix", trace_path=str(V1)))
    got = run_experiment(spec, engine="sim")
    want = jax_exp.run_experiment(
        jax_exp.ExperimentSpec.from_dict(spec.to_dict()), engine="sim")
    assert got.diff(want, ignore=("spec_sha", "wall_s")) == {}
    assert got.n_completed == 60


# --------------------------------------------------------------------------
# v2-v4 written by either package, read by the other
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", GENERATORS, ids=GEN_IDS)
def test_v2_written_alike_and_replayed_across(case, tmp_path):
    pt_wl, jax_wl = _generate(pw, case), _generate(jw, case)
    assert _fp(pt_wl) == _fp(jax_wl)
    text = _text(pw.record, pt_wl)
    assert text == _text(jw.record, jax_wl)
    assert json.loads(text.splitlines()[0])["version"] == pw.TRACE_VERSION
    path = tmp_path / "v2.jsonl"
    path.write_text(text)
    assert _fp(pw.replay(path)) == _fp(jw.replay(path)) == _fp(jax_wl)
    assert pw.events_fingerprint(pw.replay(path)) \
        == pw.events_fingerprint(pt_wl)


@pytest.mark.parametrize("case", GENERATORS, ids=GEN_IDS)
def test_v3_written_alike_and_outcomes_read_across(case, tmp_path):
    pt_wl, jax_wl = _generate(pw, case), _generate(jw, case)
    rows = _outcomes(pt_wl)
    text = _text(pw.record_v3, pt_wl, rows)
    assert text == _text(jw.record_v3, jax_wl, rows)
    path = tmp_path / "v3.jsonl"
    path.write_text(text)
    assert json.loads(text.splitlines()[0])["version"] == pw.TRACE_VERSION_V3
    assert _fp(pw.replay(path)) == _fp(jw.replay(path))
    assert pw.read_outcomes(path) == jw.read_outcomes(path) == rows


@pytest.mark.parametrize("outcomes", [False, True], ids=["plain", "outcomes"])
def test_v4_dag_written_alike_and_replayed_across(outcomes, tmp_path):
    pt_wl, jax_wl = _dag(pw), _dag(jw)
    assert pt_wl.has_deps() and _fp(pt_wl) == _fp(jax_wl)
    if outcomes:
        rows = _outcomes(pt_wl)
        text = _text(pw.record_v3, pt_wl, rows)
        assert text == _text(jw.record_v3, jax_wl, rows)
    else:
        text = _text(pw.record, pt_wl)
        assert text == _text(jw.record, jax_wl)
    assert json.loads(text.splitlines()[0])["version"] == pw.TRACE_VERSION_V4
    path = tmp_path / "v4.jsonl"
    path.write_text(text)
    assert _fp(pw.replay(path)) == _fp(jw.replay(path)) == _fp(pt_wl)
    if outcomes:
        assert pw.read_outcomes(path) == jw.read_outcomes(path)


def test_sessions_workload_traces_alike(tmp_path):
    binding = {"kind": "chat", "n_sessions": 12, "turns_per_session": 3,
               "kv_bytes_per_token": 256, "block": 16, "seed": 3}
    pt_wl = pw.build_sessions(binding)
    jax_wl = jw.build_sessions(binding)
    text = _text(pw.record, pt_wl)
    assert text == _text(jw.record, jax_wl)
    path = tmp_path / "sess.jsonl"
    path.write_text(text)
    assert _fp(pw.replay(path)) == _fp(jw.replay(path)) == _fp(jax_wl)


def test_versions_match_the_reference():
    assert pw.SUPPORTED_VERSIONS == jw.SUPPORTED_VERSIONS
    assert (pw.TRACE_VERSION, pw.TRACE_VERSION_V3, pw.TRACE_VERSION_V4) \
        == (jw.TRACE_VERSION, jw.TRACE_VERSION_V3, jw.TRACE_VERSION_V4)


# --------------------------------------------------------------------------
# malformed traces are refused with the reference's message
# --------------------------------------------------------------------------

def _v2_lines() -> list[str]:
    return _text(jw.record, _generate(jw, GENERATORS[1])).splitlines()


def _with_header(**kw) -> list[str]:
    lines = _v2_lines()
    head = json.loads(lines[0])
    head.update(kw)
    return [json.dumps(head, sort_keys=True)] + lines[1:]


BAD_TRACES = {
    "empty": [],
    "no header": _v2_lines()[1:],
    "version 9": _with_header(version=9),
    "truncated tasks": _v2_lines()[:-1],
    "unknown record": _v2_lines() + ['{"kind": "comment"}'],
    "size drift": [ln.replace('"size": 3000000', '"size": 7')
                   if '"object"' in ln and "rt.o0\"" in ln else ln
                   for ln in _v2_lines()],
    "outcomes missing": _with_header(version=3, n_outcomes=2),
}


@pytest.mark.parametrize("name", sorted(BAD_TRACES))
def test_bad_traces_refused_like_the_reference(name, tmp_path):
    path = tmp_path / "bad.jsonl"
    path.write_text("\n".join(BAD_TRACES[name]) + "\n")
    with pytest.raises(ValueError) as want:
        jw.replay(path)
    with pytest.raises(ValueError) as got:
        pw.replay(path)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["v2 has no outcomes", "missing rows"])
def test_read_outcomes_refuses_like_the_reference(name, tmp_path):
    path = tmp_path / "o.jsonl"
    lines = _v2_lines() if name == "v2 has no outcomes" \
        else _with_header(version=3, n_outcomes=5)
    path.write_text("\n".join(lines) + "\n")
    with pytest.raises(ValueError) as want:
        jw.read_outcomes(path)
    with pytest.raises(ValueError) as got:
        pw.read_outcomes(path)
    assert str(got.value) == str(want.value)


def test_record_v3_refuses_a_row_missing_a_field():
    wl = _generate(pw, GENERATORS[0])
    rows = _outcomes(wl)
    del rows[3]["exec_s"]
    with pytest.raises(ValueError) as got:
        pw.record_v3(wl, io.StringIO(), rows)
    with pytest.raises(ValueError) as want:
        jw.record_v3(_generate(jw, GENERATORS[0]), io.StringIO(), rows)
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------
# the spec binding
# --------------------------------------------------------------------------

def test_trace_binding_replays_through_build_workload(tmp_path):
    path = tmp_path / "t.jsonl"
    pw.record(_generate(pw, GENERATORS[2]), path)
    wl = build_workload(WorkloadSpec(name="t", trace_path=str(path)))
    assert _fp(wl) == _fp(jax_exp.build_workload(
        jax_exp.WorkloadSpec(name="t", trace_path=str(path))))


@pytest.mark.parametrize("bad", [
    {"trace_path": "x.jsonl", "n_tasks": 5},
    {"trace_path": "x.jsonl", "seed": 7},
    {"trace_path": "x.jsonl", "dag": {"kind": "all_pairs", "n_objects": 2}},
    {"trace_path": "x.jsonl",
     "arrivals": {"kind": "BatchArrivals"},
     "popularity": {"kind": "UniformScan"}},
    {"sessions": {"kind": "nope"}},
    {"sessions": {"kind": "chat"}, "object_bytes": 10},
    {},
])
def test_workload_bindings_refused_like_the_reference(bad):
    with pytest.raises(ValueError) as want:
        jax_exp.WorkloadSpec(**bad)
    with pytest.raises(ValueError) as got:
        WorkloadSpec(**bad)
    assert str(got.value) == str(want.value)


def _saved_reference_spec(tmp_path, **workload) -> Path:
    spec = jax_exp.ExperimentSpec(
        name="saved", workload=jax_exp.WorkloadSpec(name="w", **workload),
        observe=jax_exp.ObserveSpec(events=True, ring_capacity=4096,
                                    metrics=True, metrics_interval_s=0.5))
    path = tmp_path / "spec.json"
    spec.save(path)
    return path


@pytest.mark.parametrize("binding", ["trace", "sessions"])
def test_spec_from_json_runs_a_reference_spec_with_events_on(binding,
                                                             tmp_path):
    if binding == "trace":
        wl = {"trace_path": str(V1)}
    else:
        wl = {"sessions": {"kind": "chat", "n_sessions": 6,
                           "kv_bytes_per_token": 256, "block": 16}}
    path = _saved_reference_spec(tmp_path, **wl)
    spec = convert.spec_from_json(path)
    assert spec.observe == ObserveSpec(events=True, ring_capacity=4096,
                                       metrics=True, metrics_interval_s=0.5)
    assert spec.to_dict() == {k: v for k, v in json.loads(
        path.read_text()).items()
        if k not in ("hosts", "threads_per_host", "wire_batch",
                     "local_dispatch")}
    eng = SimEngine()
    try:
        eng.prepare(spec)
        rep = eng.run()
        n_events = len(eng.recorder.events())
    finally:
        eng.shutdown()
    jeng = jax_exp.SimEngine()
    try:
        jeng.prepare(jax_exp.ExperimentSpec.load(path))
        want = jeng.run()
        want_events = len(jeng.recorder.events())
    finally:
        jeng.shutdown()
    assert rep.diff(want, ignore=("spec_sha", "wall_s")) == {}
    assert rep.telemetry == want.telemetry
    assert n_events == want_events > 0


def test_spec_from_json_still_refuses_the_fleet(tmp_path):
    spec = jax_exp.ExperimentSpec(
        name="fleet", workload=jax_exp.WorkloadSpec(name="w",
                                                    trace_path=str(V1)),
        cluster=jax_exp.ClusterSpec(n_nodes=4), hosts=2,
        threads_per_host=2)
    path = tmp_path / "fleet.json"
    spec.save(path)
    with pytest.raises(ValueError, match="hosts=2"):
        convert.spec_from_json(path)
    d = json.loads(path.read_text())
    for name, value in (("wire_batch", 8), ("local_dispatch", True)):
        d2 = {**d, "hosts": 0, "threads_per_host": 1, name: value}
        path.write_text(json.dumps(d2))
        with pytest.raises(ValueError, match=name):
            convert.spec_from_json(path)
    path.write_text(json.dumps({**d, "hosts": 0, "threads_per_host": 1}))
    assert convert.spec_from_json(path).workload.trace_path == str(V1)
    assert dataclasses.asdict(convert.spec_from_json(path).observe) \
        == dataclasses.asdict(ObserveSpec())
