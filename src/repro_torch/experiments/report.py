"""RunReport: one comparable result schema for both engines.

`DiffusionSim` historically reported through `SimResult` (+ `RunMetrics`
via the workload layer's MetricsCollector) while `DiffusionRuntime`
reported through `RuntimeLedger` ad hoc.  A :class:`RunReport` unifies them
field-for-field: every metric is computed by the SAME code path
(``repro.workloads.MetricsCollector``) from a `SimResult`-shaped view of
the engine's observables, so "cache_hit_ratio" or "avg_slowdown" mean
*exactly* the same formula on both engines and a sim run and a runtime run
of one spec diff field-by-field (:meth:`RunReport.diff`).

Clock semantics are the one intentional difference: simulator reports are
in simulated seconds, runtime reports in wall seconds -- the ``engine``
field tags which.  Everything else (hit ratios, join splits, byte ledgers,
slowdown, performance index, pool/membership history) shares definitions;
DESIGN.md §7 is the field glossary.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Mapping

#: provenance / environment fields excluded from cross-engine diffs by
#: default (they legitimately differ between a sim and a runtime run)
IDENTITY_FIELDS = ("experiment", "engine", "spec_sha", "seed", "wall_s")


@dataclass(frozen=True)
class RunReport:
    # -- provenance ---------------------------------------------------------
    experiment: str                 # spec name
    engine: str                     # "sim" | "runtime"
    spec_sha: str                   # ExperimentSpec.fingerprint()
    seed: int
    wall_s: float                   # host wall clock spent executing
    # -- counts -------------------------------------------------------------
    n_tasks: int
    n_completed: int
    n_failed: int
    # -- clocks (engine time: simulated s | wall s) -------------------------
    makespan_s: float
    t_first_dispatch: float
    t_last_complete: float
    busy_span_s: float
    tasks_per_second: float
    # -- cache economics (per-input accounting, identical on both engines) --
    local_hits: int
    peer_hits: int
    store_reads: int
    local_hit_ratio: float
    cache_hit_ratio: float          # (local + peer) / all accesses
    # -- join (multi-input) split over completed tasks ----------------------
    mean_inputs_per_task: float
    full_hit_tasks: int
    partial_hit_tasks: int
    zero_hit_tasks: int
    # -- bytes / bandwidth --------------------------------------------------
    bytes_by_kind: dict             # kind -> bytes (local/c2c/store_read/...)
    read_bandwidth_bps: float
    moved_bandwidth_bps: float
    efficiency: float               # read bw / testbed ideal at peak pool
    # -- 0808.3535 workload metrics -----------------------------------------
    avg_slowdown: float
    p95_slowdown: float
    performance_index: float
    # -- elasticity / membership -------------------------------------------
    peak_executors: int
    low_executors: int
    executor_seconds: float
    n_allocated: int                # 0 on fixed-pool runs
    n_released: int
    pool_log: tuple                 # ((t, live executors), ...) samples
    # -- dispatcher internals (runtime only; {} on sim runs) ----------------
    dispatch_stats: dict            # DispatchStats.as_dict(): pump counts,
                                    # lock hold time, wire frame/msg totals
    # -- sim<->real divergence (repro.obs.diff output; {} unless a diff
    # joined this run's measured outcomes against a sim-twin replay) --------
    task_divergence: dict = dataclasses.field(default_factory=dict)
    # -- live-telemetry final snapshot (DESIGN.md §13; {} unless
    # observe.metrics ran): the run's last registry snapshot, per-host
    # snapshots + cluster fold, sample/health-event counts, and the
    # recorder drop count (present whenever a recorder ran) -----------------
    telemetry: dict = dataclasses.field(default_factory=dict)
    # -- DAG slowdown bases (defaulted: pre-PR-8 result files stay readable).
    # arrival = avg_slowdown's basis (submit -> end); ready measures from the
    # moment deps were met, so dep-wait does not read as scheduler queueing.
    # Dep-free runs: all three are equal.
    slowdown_from_arrival: float = 0.0
    slowdown_from_ready: float = 0.0

    # ------------------------------------------------------------------
    @classmethod
    def schema(cls) -> tuple[str, ...]:
        """Ordered field names -- identical for every engine by design."""
        return tuple(f.name for f in dataclasses.fields(cls))

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["pool_log"] = [list(p) for p in self.pool_log]
        return d

    @classmethod
    def from_dict(cls, d: Mapping) -> "RunReport":
        """Strict inverse of :meth:`as_dict` (unknown fields hard-error),
        for reading sweep results JSONL back."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - names)
        if unknown:
            raise ValueError(f"RunReport: unknown field(s) {unknown}")
        # defaulted fields (task_divergence) may be absent: pre-PR-7 result
        # files stay readable; fields WITHOUT defaults stay hard-required
        required = {f.name for f in dataclasses.fields(cls)
                    if f.default is dataclasses.MISSING
                    and f.default_factory is dataclasses.MISSING}  # type: ignore
        missing = sorted(required - set(d))
        if missing:
            raise ValueError(f"RunReport: missing field(s) {missing}")
        kw = dict(d)
        kw["pool_log"] = tuple(tuple(p) for p in d["pool_log"])
        kw["bytes_by_kind"] = dict(d["bytes_by_kind"])
        kw["dispatch_stats"] = dict(d["dispatch_stats"])
        if "task_divergence" in kw:
            kw["task_divergence"] = dict(d["task_divergence"])
        if "telemetry" in kw:
            kw["telemetry"] = dict(d["telemetry"])
        return cls(**kw)

    def diff(self, other: "RunReport",
             ignore: tuple[str, ...] = IDENTITY_FIELDS
             + ("pool_log", "dispatch_stats", "task_divergence",
                "telemetry"),
             ) -> dict[str, tuple]:
        """Field-by-field comparison: {field: (self value, other value)}
        for every differing field not in ``ignore``.  Empty dict == the two
        runs agree on every compared number (the sim-vs-runtime diffing the
        trace-v3 roadmap item needs)."""
        out: dict[str, tuple] = {}
        for f in dataclasses.fields(self):
            if f.name in ignore:
                continue
            a, b = getattr(self, f.name), getattr(other, f.name)
            if a != b:
                out[f.name] = (a, b)
        return out


def build_report(spec, engine: str, result, metrics, *, wall_s: float,
                 n_allocated: int = 0, n_released: int = 0,
                 dispatch_stats: Mapping | None = None,
                 task_divergence: Mapping | None = None,
                 telemetry: Mapping | None = None) -> RunReport:
    """Assemble a RunReport from a `SimResult`(-shaped) ``result`` and the
    `RunMetrics` computed from it.  Both engine adapters funnel through
    here, which is what pins the schemas together."""
    return RunReport(
        experiment=spec.name,
        engine=engine,
        spec_sha=spec.fingerprint(),
        seed=spec.seed,
        wall_s=wall_s,
        n_tasks=metrics.n_tasks,
        n_completed=metrics.n_completed,
        n_failed=metrics.n_failed,
        makespan_s=metrics.makespan_s,
        t_first_dispatch=result.t_first_dispatch,
        t_last_complete=result.t_last_complete,
        busy_span_s=metrics.busy_span_s,
        tasks_per_second=metrics.tasks_per_second,
        local_hits=metrics.local_hits,
        peer_hits=metrics.peer_hits,
        store_reads=metrics.store_reads,
        local_hit_ratio=metrics.local_hit_ratio,
        cache_hit_ratio=metrics.cache_hit_ratio,
        mean_inputs_per_task=metrics.mean_inputs_per_task,
        full_hit_tasks=metrics.full_hit_tasks,
        partial_hit_tasks=metrics.partial_hit_tasks,
        zero_hit_tasks=metrics.zero_hit_tasks,
        bytes_by_kind=dict(result.bytes_by_kind),
        read_bandwidth_bps=metrics.read_bandwidth_bps,
        moved_bandwidth_bps=metrics.moved_bandwidth_bps,
        efficiency=metrics.efficiency,
        avg_slowdown=metrics.avg_slowdown,
        p95_slowdown=metrics.p95_slowdown,
        performance_index=metrics.performance_index,
        slowdown_from_arrival=metrics.slowdown_from_arrival,
        slowdown_from_ready=metrics.slowdown_from_ready,
        peak_executors=metrics.peak_executors,
        low_executors=metrics.low_executors,
        executor_seconds=metrics.executor_seconds,
        n_allocated=n_allocated,
        n_released=n_released,
        pool_log=tuple(tuple(p) for p in result.pool_log),
        dispatch_stats=dict(dispatch_stats or {}),
        task_divergence=dict(task_divergence or {}),
        telemetry=dict(telemetry or {}),
    )
