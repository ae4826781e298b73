"""One experiment API over both engines (counterpart of ``repro.experiments``).

  ExperimentSpec  declarative, frozen, JSON-round-trippable run description
                  (spec.py; unknown fields hard-error)
  Engine          prepare(spec) -> run() -> RunReport protocol with the
                  SimEngine (discrete-event, simulated clock) and
                  RuntimeEngine (threaded runtime on ``device``) adapters
                  (engines.py)
  RunReport       one result schema for both engines, every metric computed
                  by the shared MetricsCollector formulas (report.py)
  Sweep           seed-paired cartesian grids over spec fields, with
                  manifest + results JSONL (sweep.py)

Quick use::

    from repro_torch.experiments import (ExperimentSpec, RuntimeEngine,
                                         WorkloadSpec, run_experiment)
    spec = ExperimentSpec(
        name="demo",
        workload=WorkloadSpec(arrivals={"kind": "PoissonArrivals",
                                        "rate_per_s": 8.0},
                              popularity={"kind": "ZipfPopularity",
                                          "alpha": 1.1, "k": 1, "corr": 1.0},
                              n_tasks=500, n_objects=50,
                              object_bytes=10**7),
    )
    report_sim = run_experiment(spec, engine="sim")
    report_rt = run_experiment(spec, engine=RuntimeEngine(device="cuda"))
    report_sim.diff(report_rt)     # field-by-field, shared schema
"""
from .engines import (ENGINES, LAZY_ENGINES, Engine, RuntimeEngine,
                      SimEngine, build_provisioner, build_recorder,
                      build_sim_config, build_workload, engine_names,
                      make_engine, resolve_task_fn, run_experiment)
from .report import IDENTITY_FIELDS, RunReport, build_report
from .spec import (ALIASES, DOCUMENTED_DIVERGENCES, CacheSpec, ClusterSpec,
                   ExperimentSpec, ObserveSpec, ProvisionerSpec,
                   WorkloadSpec, check_alias_map, with_overrides)
from .sweep import Sweep, SweepCell, load_results

__all__ = [
    "ALIASES",
    "CacheSpec",
    "ClusterSpec",
    "DOCUMENTED_DIVERGENCES",
    "ENGINES",
    "Engine",
    "ExperimentSpec",
    "IDENTITY_FIELDS",
    "LAZY_ENGINES",
    "ObserveSpec",
    "ProvisionerSpec",
    "RunReport",
    "RuntimeEngine",
    "SimEngine",
    "Sweep",
    "SweepCell",
    "WorkloadSpec",
    "build_provisioner",
    "build_recorder",
    "build_report",
    "build_sim_config",
    "build_workload",
    "check_alias_map",
    "engine_names",
    "load_results",
    "make_engine",
    "resolve_task_fn",
    "run_experiment",
    "with_overrides",
]
