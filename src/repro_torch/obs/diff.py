"""Per-task sim<->real divergence diff.

`RunReport.diff` compares two runs in aggregate; this module answers *which
tasks* diverged and *where in their lifecycle*: join measured outcome
records (trace v3 rows from a real run) against the simulator's predicted
outcomes for the same arrival trace, by task id, and report divergence
distributions -- placement agreement, byte-split agreement, and absolute
latency-error quantiles.  The result dict is what `RunReport.
task_divergence` carries and what ``tools/run_experiment.py diff`` prints.

A copy of the reference's ``repro.obs.diff`` on the port's simulator.
This package's spec has no fleet fields, so the twin only turns strict
index coherence on and observation off.
"""
from __future__ import annotations

import dataclasses

from repro_torch.workloads.metrics import latency_quantiles

from .events import exec_index, outcome_record

#: latency fields diffed between measured and predicted outcome records
LATENCY_FIELDS = ("queue_s", "exec_s", "turnaround_s")
_BYTE_FIELDS = ("bytes_local", "bytes_peer", "bytes_store")


def sim_twin_spec(spec, trace_path=None):
    """The simulator-runnable twin of a runtime (or serve) spec: same pool
    size, policy, cache and seed, but strict index coherence, and -- when
    ``trace_path`` is given -- the workload re-bound to the recorded
    arrival trace.  Observation is disabled on the twin (the diff consumes
    its dispatcher state directly)."""
    from repro_torch.experiments.spec import ObserveSpec, WorkloadSpec

    kw = dict(index_update_batch=1, observe=ObserveSpec())
    if trace_path is not None:
        kw["workload"] = WorkloadSpec(name=spec.workload.name,
                                      trace_path=str(trace_path))
    return dataclasses.replace(spec, **kw)


def sim_replay_outcomes(spec, trace_path=None, until=float("inf")):
    """Run the sim twin of ``spec`` (optionally re-bound to ``trace_path``)
    and return its predicted per-task outcome records."""
    from repro_torch.experiments.engines import SimEngine

    eng = SimEngine().prepare(sim_twin_spec(spec, trace_path))
    eng.run(until=until)
    return [outcome_record(t) for t in eng.result.dispatcher.completed]


def diff_outcomes(measured, predicted) -> dict:
    """Join measured vs. predicted outcome records by task id and summarise
    the per-task divergence.  Executor names are compared by normalized
    index (sim ``e3`` == runtime ``w3``)."""
    m = {r["tid"]: r for r in measured}
    p = {r["tid"]: r for r in predicted}
    matched = sorted(set(m) & set(p))
    n = len(matched)
    place_ok = sum(
        1 for t in matched
        if exec_index(m[t]["executor"]) == exec_index(p[t]["executor"]))
    bytes_ok = sum(
        1 for t in matched
        if all(m[t][f] == p[t][f] for f in _BYTE_FIELDS))
    return {
        "n_measured": len(m),
        "n_predicted": len(p),
        "n_matched": n,
        "n_only_measured": len(m) - n,
        "n_only_predicted": len(p) - n,
        "placement_agreement": (place_ok / n) if n else 0.0,
        "bytes_agreement": (bytes_ok / n) if n else 0.0,
        "latency_error_s": {
            f: latency_quantiles([abs(m[t][f] - p[t][f]) for t in matched])
            for f in LATENCY_FIELDS
        },
    }


def format_divergence(div: dict, latencies: bool = True) -> str:
    """Human-readable divergence summary.  ``latencies=False`` omits the
    wall-clock-dependent quantiles (reproducible-stdout callers)."""
    lines = [
        f"matched {div['n_matched']} task(s) "
        f"(measured-only {div['n_only_measured']}, "
        f"predicted-only {div['n_only_predicted']})",
        f"placement agreement  {div['placement_agreement']:.1%}",
        f"byte-split agreement {div['bytes_agreement']:.1%}",
    ]
    if latencies:
        for f in LATENCY_FIELDS:
            q = div["latency_error_s"][f]
            lines.append(
                f"|{f} error|  p50 {q['p50']:.4f}s  p90 {q['p90']:.4f}s  "
                f"p99 {q['p99']:.4f}s  mean {q['mean']:.4f}s")
    return "\n".join(lines)
