"""The experiment API on the card (counterpart of ``repro.experiments``).

  ExperimentSpec  declarative, frozen, JSON-round-trippable run description
                  (spec.py; unknown fields hard-error)
  RuntimeEngine   prepare(spec) -> run() -> RunReport over the threaded
                  runtime, on ``device`` (engines.py)
  RunReport       the reference's result schema, every metric computed by
                  the same MetricsCollector formulas (report.py)
"""
from .engines import RuntimeEngine, build_workload, resolve_task_fn
from .report import IDENTITY_FIELDS, RunReport, build_report
from .spec import CacheSpec, ClusterSpec, ExperimentSpec, WorkloadSpec

__all__ = [
    "CacheSpec",
    "ClusterSpec",
    "ExperimentSpec",
    "IDENTITY_FIELDS",
    "RunReport",
    "RuntimeEngine",
    "WorkloadSpec",
    "build_report",
    "build_workload",
    "resolve_task_fn",
]
