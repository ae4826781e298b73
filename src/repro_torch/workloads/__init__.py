"""Workload generation and run metrics (counterpart of ``repro.workloads``).

Arrival processes (arrivals.py) x object-popularity models (popularity.py)
compose into a :class:`Workload` of timed tasks (workload.py); DAG shapes
come from dags.py; finished runs reduce to the papers' headline numbers
(metrics.py).  Every generator is the reference's, so the same spec and seed
give the same events in both packages.
"""
from .arrivals import (ARRIVALS, ArrivalProcess, BatchArrivals,
                       BurstyArrivals, DiurnalArrivals, PoissonArrivals,
                       SineWaveArrivals)
from .dags import DAGS, all_pairs, build_dag, reduce_tree, stacking_pyramid
from .metrics import MetricsCollector, RunMetrics
from .popularity import (POPULARITY, PopularityModel, ShiftingWorkingSet,
                         StackingTrace, UniformScan, ZipfPopularity)
from .workload import TaskEvent, Workload, generate

__all__ = [
    "ARRIVALS",
    "ArrivalProcess",
    "BatchArrivals",
    "BurstyArrivals",
    "DAGS",
    "DiurnalArrivals",
    "MetricsCollector",
    "POPULARITY",
    "PoissonArrivals",
    "PopularityModel",
    "RunMetrics",
    "ShiftingWorkingSet",
    "SineWaveArrivals",
    "StackingTrace",
    "TaskEvent",
    "UniformScan",
    "Workload",
    "ZipfPopularity",
    "all_pairs",
    "build_dag",
    "generate",
    "reduce_tree",
    "stacking_pyramid",
]
