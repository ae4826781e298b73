"""Workload generation, trace record/replay, and run metrics (counterpart
of ``repro.workloads``).

Arrival processes (arrivals.py) x object-popularity models (popularity.py)
compose into a :class:`Workload` of timed tasks (workload.py); DAG shapes
come from dags.py and multi-turn chat sessions from sessions.py; workloads
serialise to a versioned JSONL trace and replay bit-identically (trace.py);
finished runs reduce to the papers' headline numbers (metrics.py).  Every
generator and the trace format are the reference's, so the same spec and
seed give the same events in both packages, and either package replays the
other's traces.
"""
from .arrivals import (ARRIVALS, ArrivalProcess, BatchArrivals,
                       BurstyArrivals, DiurnalArrivals, PoissonArrivals,
                       SineWaveArrivals)
from .dags import DAGS, all_pairs, build_dag, reduce_tree, stacking_pyramid
from .metrics import MetricsCollector, RunMetrics
from .popularity import (POPULARITY, PopularityModel, ShiftingWorkingSet,
                         StackingTrace, UniformScan, ZipfPopularity)
from .sessions import SESSIONS, SessionModel, build_sessions, chat_sessions
from .trace import (SUPPORTED_VERSIONS, TRACE_VERSION, TRACE_VERSION_V3,
                    TRACE_VERSION_V4, events_fingerprint, read_outcomes,
                    record, record_v3, replay)
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
    "SESSIONS",
    "SUPPORTED_VERSIONS",
    "SessionModel",
    "ShiftingWorkingSet",
    "SineWaveArrivals",
    "StackingTrace",
    "TRACE_VERSION",
    "TRACE_VERSION_V3",
    "TRACE_VERSION_V4",
    "TaskEvent",
    "UniformScan",
    "Workload",
    "ZipfPopularity",
    "all_pairs",
    "build_dag",
    "build_sessions",
    "chat_sessions",
    "events_fingerprint",
    "generate",
    "read_outcomes",
    "record",
    "record_v3",
    "reduce_tree",
    "replay",
    "stacking_pyramid",
]
