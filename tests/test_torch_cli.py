"""The port's command line against the reference's: ``run_experiment``
(describe, run, diff, sweep), ``mk_workload`` (generate, run) and
``monitor`` (render, --tail, --attach).

Each reference tool is loaded by path from ``tools/``; both ``main(argv)``s
are called in process on the same files and what they print is compared:
exactly for ``describe``, ``generate`` and the monitor's frames, and under
the stated ignore sets for run reports (``spec_sha`` and ``wall_s``; the
threaded runtime's reports on their scheduling-determined fields, replayed
batch-synchronously).  Runtime runs pass ``--device cpu``; without it the
port asks for the card.  Every run is a few hundred tasks at most."""
from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.serve.diffusion.kvmetrics import kv_summary as jax_kv_summary
from repro_torch.apps import mk_workload, monitor, run_experiment
from repro_torch.experiments import (CacheSpec, ClusterSpec, ExperimentSpec,
                                     ObserveSpec, ProvisionerSpec, RunReport,
                                     WorkloadSpec, load_results)
from repro_torch.fleet import reports_scheduling_equal
from repro_torch.obs import Telemetry, TelemetryServer
from repro_torch.serve.diffusion.kvmetrics import kv_summary

ROOT = Path(__file__).resolve().parents[1]
MB = 10**6
IGNORE = ("spec_sha", "wall_s")
CPU = ["--device", "cpu"]


def _tool(name: str):
    path = ROOT / "tools" / f"{name}.py"
    mspec = importlib.util.spec_from_file_location(f"ref_{name}", path)
    mod = importlib.util.module_from_spec(mspec)
    mspec.loader.exec_module(mod)
    return mod


REF_RUN = _tool("run_experiment")
REF_MK = _tool("mk_workload")
REF_MON = _tool("monitor")


def _call(main, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main([str(a) for a in argv])
    return rc, out.getvalue(), err.getvalue()


def _both(argv_ref, argv_pt=None):
    """(reference, port) results of one command line; the port's argv
    defaults to the reference's."""
    ref = _call(REF_RUN.main, argv_ref)
    got = _call(run_experiment.main, argv_ref if argv_pt is None
                else argv_pt)
    assert ref[0] == got[0] == 0
    return ref, got


def _zipf(n_nodes: int = 16, n_tasks: int = 160, **kw) -> ExperimentSpec:
    return ExperimentSpec(
        name="cli-zipf",
        workload=WorkloadSpec(
            name="zipf",
            arrivals={"kind": "PoissonArrivals", "rate_per_s": 40.0},
            popularity={"kind": "ZipfPopularity", "alpha": 1.1, "k": 2,
                        "corr": 0.8},
            n_tasks=n_tasks, n_objects=30, object_bytes=MB,
            compute_seconds=0.1, seed=3),
        cluster=ClusterSpec(n_nodes=n_nodes),
        cache=CacheSpec(capacity_bytes=8 * MB),
        seed=1, **kw)


SPECS = {
    "zipf": _zipf(),
    "provisioned": ExperimentSpec(
        name="cli-sine",
        workload=WorkloadSpec(
            name="sine",
            arrivals={"kind": "SineWaveArrivals", "mean_rate": 20.0,
                      "amplitude": 18.0, "period_s": 4.0, "phase": 0.0},
            popularity={"kind": "UniformScan", "stride": 1, "k": 1},
            n_tasks=200, n_objects=40, object_bytes=MB,
            compute_seconds=0.5, seed=0),
        cluster=ClusterSpec(n_nodes=1),
        provisioner=ProvisionerSpec(policy="exponential", max_executors=8,
                                    idle_timeout_s=1.0),
        seed=0),
    "dag": ExperimentSpec(
        name="cli-dag",
        workload=WorkloadSpec(
            name="dag", dag={"kind": "all_pairs", "n_objects": 6,
                             "object_bytes": MB, "dt": 0.0, "seed": 0}),
        cluster=ClusterSpec(n_nodes=4), seed=0),
    "sessions": ExperimentSpec(
        name="cli-sessions",
        workload=WorkloadSpec(
            name="chat", sessions={"kind": "chat", "n_sessions": 12,
                                   "turns_per_session": 2, "seed": 0}),
        cluster=ClusterSpec(n_nodes=4), seed=0),
}


def _save(tmp_path, spec: ExperimentSpec, name: str = "spec.json") -> Path:
    path = tmp_path / name
    spec.save(path)
    return path


def _report(path: Path) -> RunReport:
    return RunReport.from_dict(json.loads(path.read_text()))


# --------------------------------------------------------------------------
# run_experiment
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SPECS))
def test_describe_prints_what_the_reference_prints(tmp_path, name):
    spec = _save(tmp_path, SPECS[name])
    ref, got = _both(["describe", spec])
    assert got[1] == ref[1]
    assert json.loads(got[1])["fingerprint"] == SPECS[name].fingerprint()


def test_describe_refuses_a_bad_spec_as_the_reference_does(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"name": "x", "clusterr": {}}))
    msgs = []
    for main in (REF_RUN.main, run_experiment.main):
        with pytest.raises(SystemExit) as e:
            _call(main, ["describe", bad])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "bad spec" in msgs[0]


@pytest.mark.parametrize("name", ["zipf", "provisioned", "dag", "sessions"])
def test_run_on_the_sim_equals_the_reference(tmp_path, name):
    spec = _save(tmp_path, SPECS[name])
    ref, got = _both(["run", spec, "--out", tmp_path / "ref.json"],
                     ["run", spec, "--out", tmp_path / "pt.json"])
    want, have = _report(tmp_path / "ref.json"), _report(tmp_path / "pt.json")
    assert have.diff(want, ignore=IGNORE) == {}
    printed = [json.loads(r[1]) for r in (ref, got)]
    for d in printed:
        for k in IGNORE:
            d.pop(k)
    assert printed[0] == printed[1]


def test_run_on_the_runtime_equals_the_reference_on_scheduling(tmp_path):
    spec = _save(tmp_path, SPECS["zipf"])
    ref, got = _both(
        ["run", spec, "--engine", "runtime", "--barrier-every", 16,
         "--out", tmp_path / "ref.json"],
        ["run", spec, "--engine", "runtime", "--barrier-every", 16,
         "--out", tmp_path / "pt.json", *CPU])
    want, have = _report(tmp_path / "ref.json"), _report(tmp_path / "pt.json")
    assert reports_scheduling_equal(have, want) == {}
    assert have.n_completed == 160 and have.engine == "runtime"
    assert json.loads(got[1])["n_completed"] == 160
    assert got[2].splitlines()[0] == (
        "# device: cpu (host clock, not a device metric)")
    assert "device" not in ref[2]


def test_run_on_the_runtime_asks_for_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    spec = _save(tmp_path, SPECS["zipf"])
    for engine in ("runtime", "serve"):
        with pytest.raises(RuntimeError, match="cuda"):
            _call(run_experiment.main, ["run", spec, "--engine", engine])


def test_run_on_the_serve_engine_equals_the_reference(tmp_path):
    spec = _save(tmp_path, SPECS["sessions"])
    _both(["run", spec, "--engine", "serve", "--barrier-every", 4,
           "--out", tmp_path / "ref.json"],
          ["run", spec, "--engine", "serve", "--barrier-every", 4,
           "--out", tmp_path / "pt.json", *CPU])
    want, have = _report(tmp_path / "ref.json"), _report(tmp_path / "pt.json")
    assert reports_scheduling_equal(have, want) == {}
    assert have.engine == want.engine == "serve"
    assert kv_summary(have) == jax_kv_summary(want)


def test_diff_of_a_reference_trace_prints_the_reference_divergence(tmp_path):
    spec = _save(tmp_path, SPECS["zipf"])
    trace = tmp_path / "t.jsonl"
    _call(REF_RUN.main, ["run", spec, "--engine", "runtime",
                         "--barrier-every", 16, "--trace-out", trace,
                         "--out", tmp_path / "ref_report.json"])
    (tmp_path / "pt_report.json").write_text(
        (tmp_path / "ref_report.json").read_text())
    ref, got = _both(
        ["diff", spec, trace, "--out", tmp_path / "ref_div.json",
         "--report", tmp_path / "ref_report.json"],
        ["diff", spec, trace, "--out", tmp_path / "pt_div.json",
         "--report", tmp_path / "pt_report.json"])
    assert got[1] == ref[1]
    assert got[1].startswith("matched 160 task(s)")
    assert (json.loads((tmp_path / "pt_div.json").read_text())
            == json.loads((tmp_path / "ref_div.json").read_text()))
    assert (_report(tmp_path / "pt_report.json").task_divergence
            == _report(tmp_path / "ref_report.json").task_divergence)


def test_diff_of_a_port_trace_equals_the_reference_on_it(tmp_path):
    """The other way round: the port's --trace-out, diffed by both."""
    spec = _save(tmp_path, SPECS["zipf"])
    trace = tmp_path / "t.jsonl"
    _call(run_experiment.main, ["run", spec, "--engine", "runtime",
                                "--barrier-every", 16, "--trace-out", trace,
                                *CPU])
    ref, got = _both(["diff", spec, trace])
    assert got[1] == ref[1]


def _results(out_dir: Path) -> list[dict]:
    lines = [json.loads(ln) for ln in
             (out_dir / "results.jsonl").read_text().splitlines()]
    for rec in lines:
        for k in IGNORE:
            rec["report"].pop(k)
    return lines


SWEEP_SETS = ["--set", "policy=first-available,max-compute-util",
              "--set", "cache.capacity_bytes=[2000000,50000000]"]


def test_sweep_on_the_sim_equals_the_reference(tmp_path):
    spec = _save(tmp_path, SPECS["zipf"])
    ref, got = _both(
        ["sweep", spec, *SWEEP_SETS, "--seeds", "0,1",
         "--out-dir", tmp_path / "ref"],
        ["sweep", spec, *SWEEP_SETS, "--seeds", "0,1",
         "--out-dir", tmp_path / "pt"])
    assert _results(tmp_path / "pt") == _results(tmp_path / "ref")
    assert ((tmp_path / "pt" / "manifest.json").read_text()
            == (tmp_path / "ref" / "manifest.json").read_text())
    printed = [json.loads(r[1]) for r in (ref, got)]
    for d in printed:
        d.pop("out_dir")
    assert printed[0] == printed[1] and printed[0]["n_cells"] == 8
    assert got[2] == ref[2]         # the per-cell progress notes


def test_sweep_on_the_runtime_equals_the_reference(tmp_path):
    """One executor runs its queue in order, so the threaded runtime's
    sweep is deterministic without a barrier (the sweep has none)."""
    spec = _save(tmp_path, _zipf(n_nodes=1, n_tasks=60))
    _both(["sweep", spec, *SWEEP_SETS, "--engine", "runtime",
           "--out-dir", tmp_path / "ref"],
          ["sweep", spec, *SWEEP_SETS, "--engine", "runtime",
           "--out-dir", tmp_path / "pt", *CPU])
    want, have = load_results(tmp_path / "ref"), load_results(tmp_path / "pt")
    assert ((tmp_path / "pt" / "manifest.json").read_text()
            == (tmp_path / "ref" / "manifest.json").read_text())
    assert len(have) == len(want) == 4
    for (line_a, ra), (line_b, rb) in zip(have, want):
        assert line_a == line_b                 # index and overrides
        assert reports_scheduling_equal(ra, rb) == {}
        assert ra.n_completed == 60 and ra.engine == "runtime"
    hits = {rep.cache_hit_ratio for _, rep in have}
    assert len(hits) > 1            # the cache axis moves the hit ratio


def test_fleet_spec_through_the_cli_matches_the_reference(tmp_path):
    """A 2-host fleet run through the CLI on the CPU places every task as
    the reference's in-process runtime does (barrier replay)."""
    fleet = _save(tmp_path, _zipf(n_nodes=4, n_tasks=80, hosts=2,
                                  threads_per_host=2), "fleet.json")
    flat = _save(tmp_path, _zipf(n_nodes=4, n_tasks=80), "flat.json")
    _call(REF_RUN.main, ["run", flat, "--engine", "runtime",
                         "--barrier-every", 4,
                         "--out", tmp_path / "ref.json"])
    rc, out, err = _call(run_experiment.main, [
        "run", fleet, "--engine", "runtime", "--barrier-every", 4,
        "--task-fn", "repro_torch.fleet.runtime:fleet_task",
        "--timeout", 180, "--out", tmp_path / "pt.json", *CPU])
    assert rc == 0 and err.startswith("# device: cpu")
    have = _report(tmp_path / "pt.json")
    assert reports_scheduling_equal(have, _report(tmp_path / "ref.json")) \
        == {}
    assert have.n_completed == 80 and have.dispatch_stats["frames_recv"] > 0


def test_module_entry_point_keeps_stdout_pure_json(tmp_path):
    spec = _save(tmp_path, SPECS["dag"])
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.apps.run_experiment", "run",
         str(spec), "--engine", "runtime", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, env=env, cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout)["n_completed"] == 42   # 6 + 6 x 6
    assert res.stderr.startswith("# device: cpu")


# --------------------------------------------------------------------------
# mk_workload
# --------------------------------------------------------------------------

GENERATE = {
    "poisson-zipf": ["--tasks", 200, "--objects", 30, "--seed", 4],
    "sine": ["--arrivals", "sine", "--rate", 16, "--amplitude", 15,
             "--period", 20, "--popularity", "zipf", "--alpha", 1.1,
             "--tasks", 300, "--objects", 40, "--object-mb", 2],
    "join": ["--inputs-per-task", 3, "--input-corr", 0.8, "--tasks", 150,
             "--objects", 40],
    "dag": ["--dag", "all_pairs", "--dag-n", 8],
    "sessions": ["--sessions", 20, "--turns", 3, "--arrivals", "diurnal",
                 "--block", 32],
}


@pytest.mark.parametrize("name", sorted(GENERATE))
def test_generate_writes_the_reference_trace(tmp_path, name):
    res = []
    for tag, main in (("ref", REF_MK.main), ("pt", mk_workload.main)):
        out = tmp_path / f"{tag}.jsonl"
        rc, stdout, stderr = _call(main, ["generate", *GENERATE[name],
                                          "--out", out])
        assert rc == 0 and stdout == ""
        res.append((out.read_bytes(), stderr.replace(str(out), "OUT")))
    assert res[1] == res[0]
    assert res[0][1].startswith("# wrote ")


@pytest.mark.parametrize("name", ["poisson-zipf", "join", "dag",
                                  "sessions"])
def test_run_generated_inline_on_the_sim_equals_the_reference(name):
    argv = ["run", "-", *GENERATE[name], "--nodes", 8]
    printed = []
    for main in (REF_MK.main, mk_workload.main):
        rc, out, _ = _call(main, argv)
        assert rc == 0
        d = json.loads(out)
        for k in IGNORE:
            d.pop(k)
        printed.append(d)
    assert printed[0] == printed[1]
    assert "pool_log" not in printed[1]


def test_run_a_trace_file_with_provisioning_equals_the_reference(tmp_path):
    trace = tmp_path / "w.jsonl"
    _call(REF_MK.main, ["generate", *GENERATE["sine"], "--out", trace])
    argv = ["run", trace, "--nodes", 16, "--provision",
            "--alloc-policy", "additive", "--cache-gb", 0.05]
    printed = []
    for main in (REF_MK.main, mk_workload.main):
        d = json.loads(_call(main, argv)[1])
        for k in IGNORE:
            d.pop(k)
        printed.append(d)
    assert printed[0] == printed[1]
    assert printed[1]["n_allocated"] > 0


def test_run_on_the_runtime_takes_a_device(tmp_path):
    argv = ["run", "-", *GENERATE["poisson-zipf"], "--nodes", 4,
            "--engine", "runtime"]
    rc, out, err = _call(mk_workload.main, [*argv, *CPU])
    assert rc == 0 and json.loads(out)["n_completed"] == 200
    assert err == "# device: cpu (host clock, not a device metric)\n"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            _call(mk_workload.main, argv)


def test_testbed_choices_are_the_ports():
    with pytest.raises(SystemExit):
        _call(mk_workload.main, ["run", "-", "--testbed", "tpu_v5e"])
    rc, out, _ = _call(mk_workload.main, ["run", "-", "--tasks", 20,
                                          "--testbed", "anl_uc"])
    assert rc == 0 and json.loads(out)["n_completed"] == 20


# --------------------------------------------------------------------------
# monitor
# --------------------------------------------------------------------------

def _samples():
    """tests/test_telemetry.py's fixed monitor samples."""
    prev = {"t": 1.0, "metrics": {"gauges": {}}, "hosts": {
        "h0": {"metrics": {"gauges": {"bw.bytes_local": 0}}, "age_s": 0.0}}}
    sample = {
        "t": 2.0,
        "metrics": {"counters": {"sched.tasks_submitted": 9,
                                 "sched.tasks_completed": 7},
                    "gauges": {"sched.queue_depth": 2, "pool.size": 4}},
        "hosts": {"h0": {"metrics": {"gauges": {
            "cache.bytes": 2_000_000, "host.tasks_done": 7,
            "bw.bytes_local": 5_000_000}}, "age_s": 0.12}},
    }
    health = [{"kind": "health", "t": 1.5, "rule": "backlog_growth",
               "severity": "warn", "host": None, "detail": "q 1 -> 9"}]
    return prev, sample, health


@pytest.mark.parametrize("case", ["hosts", "hosts-no-prev", "solo"])
def test_render_draws_the_reference_frame(case):
    prev, sample, health = _samples()
    if case == "hosts-no-prev":
        prev = None
    if case == "solo":
        sample = {"t": 2.0, "metrics": dict(sample["metrics"], gauges={
            **sample["metrics"]["gauges"], "cache.bytes": 3_000_000,
            "bw.bytes_local": 4_000_000})}
        prev = {"t": 1.0, "metrics": {"gauges": {"bw.bytes_local": 0}}}
        health = []
    frame = monitor.render(sample, health, prev)
    assert frame == REF_MON.render(sample, health, prev)
    assert "queue=     2" in frame and "pool=   4" in frame


def _observed_run(tmp_path) -> Path:
    """A port runtime run on the CPU with the telemetry plane on."""
    sink = tmp_path / "run.metrics.jsonl"
    spec = _save(tmp_path, _zipf(n_nodes=4, n_tasks=120, observe=ObserveSpec(
        metrics=True, metrics_interval_s=0.01,
        metrics_sink_path=str(sink))))
    rc, _, _ = _call(run_experiment.main, ["run", spec, "--engine",
                                           "runtime", *CPU])
    assert rc == 0
    return sink


def test_tail_once_shows_the_runs_queue_and_pool(tmp_path):
    sink = _observed_run(tmp_path)
    recs = [json.loads(ln) for ln in sink.read_text().splitlines()]
    last = [r for r in recs if r.get("kind") == "metrics"][-1]
    g = last["metrics"]["gauges"]
    got = _call(monitor.main, ["--tail", sink, "--once"])
    want = _call(REF_MON.main, ["--tail", sink, "--once"])
    assert got == want
    assert got[0] == 0
    assert f"queue={g['sched.queue_depth']:>6}" in got[1]
    assert f"pool={g['pool.size']:>4}" in got[1]
    assert g["pool.size"] == 4
    assert f"completed={120:>7}" in got[1]


def test_tail_refuses_a_file_that_is_no_metrics_sink(tmp_path):
    bad = tmp_path / "x.jsonl"
    bad.write_text(json.dumps({"kind": "trace_header"}) + "\n")
    got = _call(monitor.main, ["--tail", bad, "--once"])
    assert got == _call(REF_MON.main, ["--tail", bad, "--once"])
    assert got[0] == 1 and "not a v1 metrics sink" in got[2]


def test_attach_once_draws_the_reference_frame():
    tel = Telemetry(interval_s=0.1)
    srv = TelemetryServer(tel, port=0)
    try:
        addr = f"127.0.0.1:{srv.port}"
        empty = _call(monitor.main, ["--attach", addr, "--once"])
        assert empty == _call(REF_MON.main, ["--attach", addr, "--once"])
        assert "(no samples yet)" in empty[1]
        tel.registry.inc("sched.tasks_completed", 4)
        tel.registry.gauge_set("sched.queue_depth", 3)
        tel.registry.gauge_set("pool.size", 5)
        tel.record_sample(1.0)
        got = _call(monitor.main, ["--attach", addr, "--once"])
        assert got == _call(REF_MON.main, ["--attach", addr, "--once"])
        assert "queue=     3" in got[1] and "pool=   5" in got[1]
    finally:
        srv.close()
