"""The port's telemetry plane against the JAX package's: registry and
histogram math, the snapshot merge algebra, the JSONL sink, the cluster
view, the health rules, the status endpoint, the simulator's virtual-time
sampling (its RunReport.telemetry equals the reference's exactly), the
threaded runtime's samples (equal to the reference runtime's in every
scheduling-determined gauge and counter) and the free-when-off contract."""
import dataclasses
import json
import math
import random
import threading

import pytest

import repro_torch.experiments as pt_exp
from repro import experiments as jax_exp
from repro import obs as jobs
from repro import workloads as jw
from repro.core import DataObject as JaxDataObject
from repro.obs.metrics import LATENCY_BOUNDS_S as JAX_BOUNDS
from repro_torch import obs as pobs
from repro_torch import workloads as pw
from repro_torch.core.objects import DataObject
from repro_torch.experiments import (ClusterSpec, ExperimentSpec, ObserveSpec,
                                     RunReport, RuntimeEngine, SimEngine,
                                     WorkloadSpec)
from repro_torch.obs.metrics import LATENCY_BOUNDS_S
from repro_torch.serve.diffusion import (ServeDiffusionEngine,
                                         session_spec)


def _jax(spec: ExperimentSpec):
    return jax_exp.ExperimentSpec.from_dict(spec.to_dict())


# --------------------------------------------------------------------------
# registry, histograms, merge
# --------------------------------------------------------------------------

def _drive(reg, seed: int, n: int = 300) -> None:
    rng = random.Random(seed)
    for i in range(n):
        reg.inc("tasks")
        reg.inc("bytes", rng.randrange(1000))
        reg.observe("lat", rng.uniform(1e-6, 2.0))
        reg.observe("h", rng.uniform(0.0, 5.0), bounds=(1.0, 2.0, 4.0))
        if i % 7 == 0:
            reg.gauge_set("cache.bytes", rng.randrange(10**6))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshots_equal_the_reference(seed):
    got, want = pobs.MetricsRegistry(), jobs.MetricsRegistry()
    _drive(got, seed)
    _drive(want, seed)
    assert got.snapshot() == want.snapshot()
    assert got.counter("tasks") == want.counter("tasks") == 300
    assert got.gauge("cache.bytes") == want.gauge("cache.bytes")
    assert got.counter("absent") == 0 and got.gauge("absent") == 0.0
    snap = got.snapshot()
    for name in ("lat", "h"):
        for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
            assert pobs.quantile(snap["histograms"][name], q) \
                == jobs.quantile(snap["histograms"][name], q)


def test_bounds_and_validation_match_the_reference():
    assert LATENCY_BOUNDS_S == JAX_BOUNDS
    assert pobs.METRICS_SCHEMA_VERSION == jobs.METRICS_SCHEMA_VERSION
    for bounds in ((2.0, 1.0), ()):
        with pytest.raises(ValueError) as want:
            jobs.MetricsRegistry().observe("h", 1.0, bounds=bounds)
        with pytest.raises(ValueError) as got:
            pobs.MetricsRegistry().observe("h", 1.0, bounds=bounds)
        assert str(got.value) == str(want.value)
    h = {"bounds": [1.0], "counts": [0, 0], "sum": 0.0, "count": 0}
    assert pobs.quantile(h, 0.5) == jobs.quantile(h, 0.5) == 0.0
    with pytest.raises(ValueError, match="q must be"):
        pobs.quantile(h, 1.5)


def test_quantile_within_bucket_resolution():
    """For any q, the estimate is the upper bound of the bucket holding the
    true q-quantile value: prev_bound < v_true <= estimate."""
    rng = random.Random(0)
    vals = [rng.uniform(1e-5, 0.9) for _ in range(500)]
    r = pobs.MetricsRegistry()
    for v in vals:
        r.observe("lat", v)
    h = r.snapshot()["histograms"]["lat"]
    svals = sorted(vals)
    for q in (0.01, 0.1, 0.5, 0.9, 0.99):
        est = pobs.quantile(h, q)
        v_true = svals[max(math.ceil(q * len(svals)) - 1, 0)]
        i = list(h["bounds"]).index(est)
        lo = h["bounds"][i - 1] if i else 0.0
        assert lo < v_true <= est, (q, v_true, est)


@pytest.mark.parametrize("seeds", [(0, 1), (2, 3), (4, 4)])
def test_merge_equals_observing_union_and_the_reference(seeds):
    parts = []
    for s in seeds:
        reg = pobs.MetricsRegistry()
        _drive(reg, s, n=100)
        parts.append(reg.snapshot())
    got = pobs.merge_snapshots(*parts)
    assert got == jobs.merge_snapshots(*parts)
    union = pobs.MetricsRegistry()
    for s in seeds:
        _drive(union, s, n=100)
    want = union.snapshot()
    assert got["counters"] == want["counters"]
    for name in ("lat", "h"):
        assert got["histograms"][name]["counts"] \
            == want["histograms"][name]["counts"]
    a, b = pobs.MetricsRegistry(), pobs.MetricsRegistry()
    a.observe("h", 0.5, bounds=(1.0, 2.0))
    b.observe("h", 0.5, bounds=(1.0, 4.0))
    with pytest.raises(ValueError, match="bounds mismatch"):
        pobs.merge_snapshots(a.snapshot(), b.snapshot())


def test_counters_monotone_under_concurrent_emit():
    r = pobs.MetricsRegistry()
    seen: list[int] = []
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            seen.append(r.counter("c"))

    def writer():
        for _ in range(4000):
            r.inc("c")
            r.observe("lat", 1e-4)

    rt = threading.Thread(target=reader)
    ws = [threading.Thread(target=writer) for _ in range(4)]
    rt.start()
    for w in ws:
        w.start()
    for w in ws:
        w.join(timeout=60)
    stop.set()
    rt.join(timeout=60)
    assert not rt.is_alive() and not any(w.is_alive() for w in ws)
    assert r.counter("c") == 16000       # no lost increments
    assert r.snapshot()["histograms"]["lat"]["count"] == 16000
    assert seen == sorted(seen)


# --------------------------------------------------------------------------
# the Telemetry bundle, sink, cluster view
# --------------------------------------------------------------------------

def _record_series(pkg, path, health=None) -> object:
    tel = pkg.Telemetry(interval_s=0.5, sink_path=str(path), health=health)
    for i in range(6):
        tel.registry.inc("sched.tasks_completed", i)
        tel.registry.gauge_set("sched.queue_depth", 3 * i)
        tel.registry.gauge_set("cache.readmits", 10 * i)
        tel.record_sample(0.5 * (i + 1), per_host=None if i % 2 else {
            "h0": {"metrics": {"gauges": {"cache.bytes": 11 * i}},
                   "age_s": 0.1 * i}})
    tel.close()
    return tel


@pytest.mark.parametrize("health", [False, True])
def test_sink_written_like_the_reference(health, tmp_path):
    got = _record_series(pobs, tmp_path / "pt.jsonl",
                         pobs.HealthMonitor(window=2) if health else None)
    want = _record_series(jobs, tmp_path / "jax.jsonl",
                          jobs.HealthMonitor(window=2) if health else None)
    assert (tmp_path / "pt.jsonl").read_text() \
        == (tmp_path / "jax.jsonl").read_text()
    assert list(got.series) == list(want.series)
    assert got.merged_last() == want.merged_last()
    assert got.health_events == want.health_events
    assert bool(got.health_events) == health
    assert pobs.read_metrics(tmp_path / "jax.jsonl") \
        == jobs.read_metrics(tmp_path / "pt.jsonl")


def test_read_metrics_and_bundle_refuse_like_the_reference(tmp_path):
    p = tmp_path / "x.jsonl"
    for text in (json.dumps({"kind": "header"}) + "\n", "",
                 json.dumps({"kind": "metrics_header",
                             "schema_version": 99}) + "\n"):
        p.write_text(text)
        with pytest.raises(ValueError) as want:
            jobs.read_metrics(p)
        with pytest.raises(ValueError) as got:
            pobs.read_metrics(p)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="interval_s"):
        pobs.Telemetry(interval_s=0.0)
    tel = pobs.Telemetry(interval_s=0.1, series_capacity=3)
    for i in range(10):
        tel.record_sample(float(i))
    assert [s["t"] for s in tel.series] == [7.0, 8.0, 9.0]


def test_cluster_view_like_the_reference():
    views = (pobs.ClusterView(), jobs.ClusterView())
    for cv in views:
        cv.update("h0", {"metrics": {"counters": {"c": 1}, "histograms": {},
                                     "gauges": {"cache.bytes": 10}}})
        cv.update("h1", {"metrics": {"counters": {"c": 2}, "histograms": {},
                                     "gauges": {"cache.bytes": 32}}})
        cv.update("h0", {"metrics": {"counters": {"c": 5}, "histograms": {},
                                     "gauges": {"cache.bytes": 12}}})
    got, want = views
    assert got.merged() == want.merged()
    assert got.merged()["gauges"]["cache.bytes"] == 44
    assert got.seqs() == want.seqs() == {"h0": 3, "h1": 2}
    assert set(got.per_host()) == {"h0", "h1"}
    assert all(d["age_s"] >= 0 for d in got.per_host().values())
    got.drop("h0")
    assert set(got.seqs()) == {"h1"}


# --------------------------------------------------------------------------
# health rules
# --------------------------------------------------------------------------

def _sample(t, depth=0, readmits=0, dropped=0, hosts=None):
    rec = {"kind": "metrics", "t": t,
           "metrics": {"counters": {}, "histograms": {},
                       "gauges": {"sched.queue_depth": depth,
                                  "cache.readmits": readmits,
                                  "obs.recorder_dropped": dropped}}}
    if hosts is not None:
        rec["hosts"] = hosts
    return rec


def _stream(kind: str) -> list[dict]:
    if kind == "backlog":
        return [_sample(0.5 * i, depth=d)
                for i, d in enumerate([1, 5, 10, 12, 12, 13, 14, 2, 9, 20])]
    if kind == "thrash":
        return [_sample(0.5 * i, readmits=r)
                for i, r in enumerate([0, 5, 5, 30, 31, 90])]
    if kind == "drops":
        return [_sample(0.5 * i, dropped=d)
                for i, d in enumerate([0, 0, 7, 7, 9])]
    fresh = {"h0": {"metrics": {}, "age_s": 0.1},
             "h1": {"metrics": {}, "age_s": 0.2}}
    stale = {"h0": {"metrics": {}, "age_s": 3.5},
             "h1": {"metrics": {}, "age_s": 0.2}}
    return [_sample(0.5 * i, hosts=h)
            for i, h in enumerate([fresh, stale, stale, fresh, stale])]


@pytest.mark.parametrize("kind", ["backlog", "thrash", "drops", "stale"])
@pytest.mark.parametrize("window", [2, 3, 5])
def test_health_events_equal_the_reference(kind, window):
    got = pobs.HealthMonitor(window=window, backlog_min=8, thrash_min=4,
                             stale_after_s=2.0)
    want = jobs.HealthMonitor(window=window, backlog_min=8, thrash_min=4,
                              stale_after_s=2.0)
    fired = []
    for s in _stream(kind):
        ev = got.observe(s)
        assert ev == want.observe(s)
        fired += ev
    if kind in ("drops", "stale") or (kind == "backlog" and window <= 3) \
            or kind == "thrash":
        assert fired, (kind, window)
    with pytest.raises(ValueError, match="window"):
        pobs.HealthMonitor(window=1)


def test_telemetry_server_roundtrip():
    tel = pobs.Telemetry(interval_s=0.1)
    srv = pobs.TelemetryServer(tel, port=0)
    try:
        rec = pobs.fetch_telemetry("127.0.0.1", srv.port)
        assert rec == {"kind": "telemetry", "sample": None, "health": []}
        tel.registry.inc("sched.tasks_completed", 4)
        tel.record_sample(1.0)
        rec = pobs.fetch_telemetry("127.0.0.1", srv.port)
        assert rec["sample"]["metrics"]["counters"][
            "sched.tasks_completed"] == 4
        # the reference's client reads the port's endpoint
        assert jobs.fetch_telemetry("127.0.0.1", srv.port) == rec
    finally:
        srv.close()


# --------------------------------------------------------------------------
# engines
# --------------------------------------------------------------------------

def _wspec(n_tasks=30):
    return WorkloadSpec(
        name="tel",
        arrivals={"kind": "BatchArrivals", "at_s": 0.0},
        popularity={"kind": "ZipfPopularity", "alpha": 1.1, "k": 2,
                    "corr": 1.0},
        n_tasks=n_tasks, n_objects=12, object_bytes=10_000, seed=7)


def _serial_workload(pkg_object, pkg_workloads, n_tasks=30):
    rng = random.Random(7)
    objs = [pkg_object(f"p.o{i}", 10_000) for i in range(12)]
    events = [pkg_workloads.TaskEvent(
        t=float(i), tid=f"p-{i}",
        inputs=tuple(o.oid for o in rng.sample(objs, 2)), outputs=(),
        compute_seconds=0.0, store_metadata_ops=0) for i in range(n_tasks)]
    return pkg_workloads.Workload("tel", objs, events, spec=None)


def _spec(*, metrics=True, interval=0.25, sink=None, events=False):
    return ExperimentSpec(
        name="telemetry-par",
        cluster=ClusterSpec(testbed="anl_uc", n_nodes=4),
        policy="max-compute-util", workload=_wspec(),
        observe=ObserveSpec(events=events, metrics=metrics,
                            metrics_interval_s=interval,
                            metrics_sink_path=sink),
        seed=3)


SCHED_FIELDS = ("n_tasks", "n_completed", "n_failed", "local_hits",
                "peer_hits", "store_reads", "local_hit_ratio",
                "cache_hit_ratio", "full_hit_tasks", "partial_hit_tasks",
                "zero_hit_tasks", "bytes_by_kind", "mean_inputs_per_task",
                "peak_executors")

SIM_CASES = {
    "serial": (dict(), True),
    "serial-events": (dict(events=True), True),
    "batch": (dict(), False),
    "batch-fine": (dict(interval=0.05), False),
}


def _sim(pkg_exp, spec, wl):
    eng = pkg_exp.SimEngine()
    try:
        eng.prepare(spec, workload=wl)
        rep = eng.run()
        return rep, list(eng.telemetry.series)
    finally:
        eng.shutdown()


@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_sim_telemetry_equals_the_reference(case):
    kw, serial = SIM_CASES[case]
    spec = _spec(**kw)
    wl = _serial_workload(DataObject, pw) if serial else None
    jwl = _serial_workload(JaxDataObject, jw) if serial else None
    rep, series = _sim(pt_exp, spec, wl)
    jrep, jseries = _sim(jax_exp, _jax(spec), jwl)
    assert rep.telemetry == jrep.telemetry
    assert series == jseries
    tel = rep.telemetry
    assert tel["n_samples"] == len(series) >= 2
    interval = spec.observe.metrics_interval_s
    for s in series[:-1]:
        ratio = s["t"] / interval
        assert abs(ratio - round(ratio)) < 1e-6, s["t"]
    final = tel["metrics"]
    assert final["counters"]["sched.tasks_submitted"] == 30
    assert final["counters"]["sched.tasks_completed"] == 30
    assert final["gauges"]["sched.queue_depth"] == 0
    bk = rep.bytes_by_kind
    assert final["gauges"]["bw.bytes_local"] == bk.get("local", 0)
    assert final["gauges"]["bw.bytes_c2c"] == bk.get("c2c", 0)
    assert final["gauges"]["bw.bytes_store"] == bk.get("store_read", 0)
    assert tel["merged"] == final


def test_sim_metrics_off_is_free_and_identical():
    reps = {}
    for label, metrics in (("off", False), ("on", True)):
        eng = SimEngine()
        try:
            eng.prepare(_spec(metrics=metrics),
                        workload=_serial_workload(DataObject, pw))
            reps[label] = eng.run()
            if not metrics:
                assert eng.telemetry is None
                assert eng.sim.metrics is None
                assert eng.sim.dispatcher.metrics is None
        finally:
            eng.shutdown()
    assert reps["off"].telemetry == {}
    for f in SCHED_FIELDS:
        assert getattr(reps["off"], f) == getattr(reps["on"], f), f


def test_sim_sink_written_like_the_reference(tmp_path):
    spec = _spec(sink=str(tmp_path / "pt.jsonl"))
    jspec = dataclasses.replace(_jax(spec), observe=jax_exp.ObserveSpec(
        metrics=True, metrics_interval_s=0.25,
        metrics_sink_path=str(tmp_path / "jax.jsonl")))
    rep, _ = _sim(pt_exp, spec,
                  _serial_workload(DataObject, pw, 5))
    _sim(jax_exp, jspec, _serial_workload(JaxDataObject, jw, 5))
    assert (tmp_path / "pt.jsonl").read_text() \
        == (tmp_path / "jax.jsonl").read_text()
    header, samples, _ = pobs.read_metrics(tmp_path / "pt.jsonl")
    assert header["interval_s"] == 0.25
    assert len(samples) == rep.telemetry["n_samples"]


@pytest.fixture(scope="module")
def runtime_runs():
    """Barrier-replay of one workload on the port's runtime (CPU) and on the
    reference's, metrics on both; and the port's with metrics off."""
    out = {}
    for label, eng, spec, wl in (
            ("pt", RuntimeEngine(device="cpu"), _spec(),
             _serial_workload(DataObject, pw)),
            ("pt-off", RuntimeEngine(device="cpu"), _spec(metrics=False),
             _serial_workload(DataObject, pw)),
            ("jax", jax_exp.RuntimeEngine(), _jax(_spec()),
             _serial_workload(JaxDataObject, jw))):
        try:
            eng.prepare(spec, workload=wl)
            out[label] = (eng.run(barrier_every=1, timeout=120.0), eng)
        finally:
            eng.shutdown()
    return out


def test_runtime_final_snapshot_equals_the_reference(runtime_runs):
    """Every scheduling-determined counter and gauge of the settled final
    sample is the reference runtime's; only the pump-latency histogram's
    buckets and sum (wall clock) may differ."""
    got = runtime_runs["pt"][0].telemetry
    want = runtime_runs["jax"][0].telemetry
    assert got["metrics"]["gauges"] == want["metrics"]["gauges"]
    assert got["metrics"]["counters"] == want["metrics"]["counters"]
    hist = got["metrics"]["histograms"]["sched.pump_latency_s"]
    assert hist["count"] == want["metrics"]["histograms"][
        "sched.pump_latency_s"]["count"] == got["metrics"]["counters"][
        "sched.pump_calls"]
    assert got["merged"] == got["metrics"]
    assert got["health_events"] == [] and got["hosts"] == {}
    assert got["n_samples"] >= 1
    final = got["metrics"]
    rep = runtime_runs["pt"][0]
    assert final["counters"]["sched.tasks_completed"] == 30
    assert final["gauges"]["pool.size"] == 4
    bk = rep.bytes_by_kind
    assert final["gauges"]["bw.bytes_local"] == bk.get("local", 0)
    assert final["gauges"]["bw.bytes_store"] == bk.get("store_read", 0)


def test_runtime_metrics_off_is_free_and_identical(runtime_runs):
    off_rep, off_eng = runtime_runs["pt-off"]
    assert off_rep.telemetry == {}
    assert off_eng.telemetry is None and off_eng.runtime.metrics is None
    assert off_eng.runtime.dispatcher.metrics is None
    for f in SCHED_FIELDS:
        assert getattr(off_rep, f) == getattr(runtime_runs["pt"][0], f), f


def test_runtime_sampler_ticks_at_a_fixed_rate():
    """A sample that takes most of an interval does not push the later
    ones back: the k-th sample lands near k intervals after the start (a
    tick that waited an interval after each sample would drift by the
    sample's cost every tick)."""
    import time
    from types import SimpleNamespace

    from repro_torch.experiments.engines import _TelemetrySampler

    interval, cost, n = 0.1, 0.06, 8
    eng = SimpleNamespace(
        runtime=SimpleNamespace(sample_metrics=lambda: time.sleep(cost)),
        _engine_gauges=lambda: None,
        telemetry=pobs.Telemetry(interval_s=interval))
    sampler = _TelemetrySampler(eng, time.monotonic())
    sampler.start()
    try:
        deadline = time.monotonic() + 10.0
        while len(eng.telemetry.series) < n and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        sampler.stop()
        sampler.join(5.0)
    stamps = [s["t"] for s in eng.telemetry.series]
    assert len(stamps) >= n
    assert stamps == sorted(stamps)
    # drifting, the n-th stamp would be n * (interval + cost) = 1.28 s
    assert stamps[n - 1] < n * interval + 2 * cost, stamps


def test_report_telemetry_roundtrips_and_diff_ignores():
    rep, _ = _sim(pt_exp, _spec(),
                  _serial_workload(DataObject, pw, 5))
    assert rep.telemetry["n_samples"] >= 1
    assert RunReport.from_dict(json.loads(json.dumps(rep.as_dict()))) == rep
    stripped = dataclasses.replace(rep, telemetry={})
    assert rep.diff(stripped) == {}
    d = rep.as_dict()
    del d["telemetry"]
    assert RunReport.from_dict(d).telemetry == {}


def test_serve_engine_samples_kv_gauges():
    """The serve engine's ``_engine_gauges`` adds the KV-reuse byte split
    to every sample, equal to the ledger's at the end of the run."""
    binding = {"kind": "chat", "n_sessions": 8, "turns_per_session": 3,
               "kv_bytes_per_token": 256, "block": 16, "think_time_s": 0.0,
               "turn_seconds": 0.0,
               "arrivals": {"kind": "BatchArrivals", "at_s": 0.0}}
    spec = session_spec("tel-serve", binding, n_replicas=3, seed=1,
                        observe=ObserveSpec(metrics=True,
                                            metrics_interval_s=0.05))
    eng = ServeDiffusionEngine(device="cpu")
    try:
        eng.prepare(spec)
        rep = eng.run(barrier_every=1, timeout=120.0)
    finally:
        eng.shutdown()
    g = rep.telemetry["metrics"]["gauges"]
    bk = rep.bytes_by_kind
    assert g["serve.kv_reused_bytes"] == bk["local"] + bk["c2c"] > 0
    assert g["serve.kv_prefill_bytes"] == bk["store_read"] > 0
