"""Low-overhead observability for both engines (counterpart of ``repro.obs``).

Per-task lifecycle events (arrived -> queued -> dispatched -> per-input
resolve -> exec start/end -> done/failed/requeued, plus pool, pump and
provisioner transitions) recorded into a bounded ring buffer (`Recorder`),
exported as Chrome-trace JSON (`export.chrome_trace`) and diffed
task-by-task between a measured run and its simulator replay
(`diff.diff_outcomes`).

Recording is off by default and free when off: every hot-path hook is a
``if recorder is not None`` guard.

The live telemetry plane rides alongside: a lock-cheap `MetricsRegistry`
(counters / gauges / fixed-bucket histograms with mergeable snapshots), the
per-run `Telemetry` bundle with its JSONL time series, the `ClusterView`
that folds per-host snapshots (fed by a multi-process fleet), a
`HealthMonitor` evaluating window rules over the stream, and the
`TelemetryServer` status endpoint.  Same free-when-off contract:
``metrics is None`` unless the spec asks.

Everything here runs on the host; the event stream, the traces and the
snapshots equal the reference's for the same run.

The port's own additions: a second ring of timed spans inside a request
(store copy, task function, kernel launch, collection pause; see
``Recorder.span``), realtime anchors that put them on ``torch.profiler``'s
clock, and `timeline.name_idle_gaps`, which names each idle gap of the card
by the host spans open across it.
"""
from .events import (
    EVENT_SCHEMA_VERSION,
    EVENT_KINDS,
    LIFECYCLE_KINDS,
    OUTCOME_FIELDS,
    SPAN_KINDS,
    exec_index,
    lifecycle_fingerprints,
    outcome_record,
)
from .recorder import Recorder, load_events, request
from .export import chrome_trace
from .timeline import name_idle_gaps
from .diff import (diff_outcomes, format_divergence, sim_replay_outcomes,
                   sim_twin_spec)
from .metrics import (METRICS_SCHEMA_VERSION, ClusterView, MetricsRegistry,
                      Telemetry, TelemetryServer, fetch_telemetry,
                      merge_snapshots, quantile, read_metrics)
from .health import HealthMonitor

__all__ = [
    "EVENT_SCHEMA_VERSION",
    "EVENT_KINDS",
    "LIFECYCLE_KINDS",
    "METRICS_SCHEMA_VERSION",
    "OUTCOME_FIELDS",
    "SPAN_KINDS",
    "ClusterView",
    "HealthMonitor",
    "MetricsRegistry",
    "Recorder",
    "Telemetry",
    "TelemetryServer",
    "chrome_trace",
    "diff_outcomes",
    "exec_index",
    "fetch_telemetry",
    "format_divergence",
    "lifecycle_fingerprints",
    "load_events",
    "merge_snapshots",
    "name_idle_gaps",
    "outcome_record",
    "quantile",
    "read_metrics",
    "request",
    "sim_replay_outcomes",
    "sim_twin_spec",
]
