"""The simulator's result record, which the threaded runtime also reports in.

``SimResult`` is the shape ``MetricsCollector`` reads; the runtime engine
builds one from its own observables (``RuntimeEngine._result_view``), so
every RunReport number is computed by the same formula as the reference's.
The discrete-event simulator itself is not part of this package.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

from .scheduler import Dispatcher


@dataclass
class SimResult:
    makespan: float
    t_first_dispatch: float
    t_last_complete: float
    bytes_by_kind: dict[str, float]
    n_completed: int
    n_failed: int
    local_hits: int
    peer_hits: int
    store_reads: int
    dispatcher: Dispatcher
    flow_log: list[tuple[float, float, float, str]]
    # (t, live-executor count) samples; one initial entry, then one per
    # membership change.  MetricsCollector integrates this for the
    # provisioning metrics (executor-seconds, performance index).
    pool_log: list[tuple[float, int]] = field(default_factory=list)

    @property
    def busy_span(self) -> float:
        return max(self.t_last_complete - self.t_first_dispatch, 1e-12)

    def read_throughput(self) -> float:
        """Bytes/s of task input consumption (local + c2c + store reads)."""
        b = self.bytes_by_kind
        total = b.get("local", 0) + b.get("c2c", 0) + b.get("store_read", 0)
        return total / self.busy_span

    def moved_throughput(self) -> float:
        """Bytes/s of all reads+writes (the paper's read+write metric)."""
        return sum(self.bytes_by_kind.values()) / self.busy_span

    def throughput_of(self, kinds: Sequence[str]) -> float:
        return sum(self.bytes_by_kind.get(k, 0) for k in kinds) / self.busy_span

    @property
    def local_hit_ratio(self) -> float:
        n = self.local_hits + self.peer_hits + self.store_reads
        return self.local_hits / n if n else 0.0

    @property
    def global_hit_ratio(self) -> float:
        """Paper's cache-hit metric: any access avoiding persistent storage."""
        n = self.local_hits + self.peer_hits + self.store_reads
        return (self.local_hits + self.peer_hits) / n if n else 0.0

    def tasks_per_second(self) -> float:
        return self.n_completed / self.busy_span
