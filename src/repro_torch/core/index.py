"""Centralized (and optionally sharded) cache-location index (§3.2.3).

The dispatcher keeps an in-memory map ``oid -> {executor ids caching it}``,
kept *loosely coherent* with executor caches via update batches.  The paper
measures a Java hash table at ~1-3 us inserts / 0.25-1 us lookups and an
upper bound of ~4.18M lookups/s, and argues a centralized index beats a
distributed one (P-RLS) until ~32K index nodes; ``time_ops`` and the
``prls_*`` model below are that comparison (Figure 2), timed on the host.

Loose coherence protocol: executors enqueue ``IndexUpdate`` records (adds on
cache insertion, removes on eviction) which the dispatcher applies in batches.
Between batches the index may be stale in both directions; the scheduler
treats hints as advisory (a peer fetch that misses falls back to the store)
so staleness costs performance, never correctness -- exactly the paper's
"hybrid but essentially centralized" design.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Iterable


@dataclass(frozen=True, slots=True)
class IndexUpdate:
    executor: str
    added: tuple[str, ...] = ()
    removed: tuple[str, ...] = ()


class LocationIndex:
    """Single-node in-memory location index (the paper's choice)."""

    def __init__(self) -> None:
        self._by_oid: dict[str, set[str]] = {}
        self._by_executor: dict[str, set[str]] = {}
        self.n_inserts = 0
        self.n_removes = 0
        self.n_lookups = 0

    # -- point ops -----------------------------------------------------------
    def insert(self, oid: str, executor: str) -> None:
        self._by_oid.setdefault(oid, set()).add(executor)
        self._by_executor.setdefault(executor, set()).add(oid)
        self.n_inserts += 1

    def remove(self, oid: str, executor: str) -> None:
        locs = self._by_oid.get(oid)
        if locs is not None:
            locs.discard(executor)
            if not locs:
                del self._by_oid[oid]
        exo = self._by_executor.get(executor)
        if exo is not None:
            exo.discard(oid)
        self.n_removes += 1

    def lookup(self, oid: str) -> frozenset[str]:
        self.n_lookups += 1
        locs = self._by_oid.get(oid)
        return frozenset(locs) if locs else frozenset()

    # -- bulk / maintenance ----------------------------------------------------
    def apply(self, update: IndexUpdate) -> None:
        for oid in update.added:
            self.insert(oid, update.executor)
        for oid in update.removed:
            self.remove(oid, update.executor)

    def apply_batch(self, updates: Iterable[IndexUpdate]) -> None:
        for u in updates:
            self.apply(u)

    def apply_wire(self, triples: Iterable[Iterable]) -> None:
        """Apply ``[executor, added, removed]`` triples as they cross the
        fleet wire (host index replicas decode straight into this -- no
        IndexUpdate re-tupling on the hot path)."""
        for eid, added, removed in triples:
            for oid in added:
                self.insert(oid, eid)
            for oid in removed:
                self.remove(oid, eid)

    def drop_executor(self, executor: str) -> int:
        """Invalidate every entry for a released/failed executor."""
        oids = self._by_executor.pop(executor, set())
        for oid in oids:
            locs = self._by_oid.get(oid)
            if locs is not None:
                locs.discard(executor)
                if not locs:
                    del self._by_oid[oid]
        return len(oids)

    def holdings(self, executor: str) -> frozenset[str]:
        return frozenset(self._by_executor.get(executor, ()))

    def __len__(self) -> int:
        return len(self._by_oid)

    # -- micro-benchmark hooks (paper §3.2.3 / Figure 2) -----------------------
    def time_ops(self, n: int = 100_000) -> dict[str, float]:
        """Measure insert/lookup latency; returns seconds-per-op."""
        return _time_ops(self, n)


class ShardedIndex:
    """Hash-sharded variant (beyond-paper).

    Addresses the two §3.2.3 limitations the paper itself raises -- memory
    footprint and single point of failure -- while keeping per-shard lookups
    O(1).  Shards can live on different service processes; here they are
    in-process but the interface is shard-local so the split is mechanical.
    A fleet host keeps its index replica in one (``repro_torch.fleet``).
    """

    def __init__(self, n_shards: int = 8) -> None:
        if n_shards < 1:
            raise ValueError("need >= 1 shard")
        self._shards = [LocationIndex() for _ in range(n_shards)]

    def _shard(self, oid: str) -> LocationIndex:
        return self._shards[hash(oid) % len(self._shards)]

    def insert(self, oid: str, executor: str) -> None:
        self._shard(oid).insert(oid, executor)

    def remove(self, oid: str, executor: str) -> None:
        self._shard(oid).remove(oid, executor)

    def lookup(self, oid: str) -> frozenset[str]:
        return self._shard(oid).lookup(oid)

    def apply(self, update: IndexUpdate) -> None:
        for oid in update.added:
            self.insert(oid, update.executor)
        for oid in update.removed:
            self.remove(oid, update.executor)

    def apply_batch(self, updates: Iterable[IndexUpdate]) -> None:
        for u in updates:
            self.apply(u)

    def apply_wire(self, triples: Iterable[Iterable]) -> None:
        for eid, added, removed in triples:
            for oid in added:
                self.insert(oid, eid)
            for oid in removed:
                self.remove(oid, eid)

    def drop_executor(self, executor: str) -> int:
        return sum(s.drop_executor(executor) for s in self._shards)

    def holdings(self, executor: str) -> frozenset[str]:
        out: set[str] = set()
        for s in self._shards:
            out |= s.holdings(executor)
        return frozenset(out)

    def __len__(self) -> int:
        return sum(len(s) for s in self._shards)

    # -- aggregate op counters: drop-in observable like LocationIndex ---------
    @property
    def n_inserts(self) -> int:
        return sum(s.n_inserts for s in self._shards)

    @property
    def n_removes(self) -> int:
        return sum(s.n_removes for s in self._shards)

    @property
    def n_lookups(self) -> int:
        return sum(s.n_lookups for s in self._shards)

    def time_ops(self, n: int = 100_000) -> dict[str, float]:
        """Measure insert/lookup latency across shards; seconds-per-op
        (same contract as LocationIndex.time_ops)."""
        return _time_ops(self, n)


def _time_ops(index, n: int) -> dict[str, float]:
    t0 = time.perf_counter()
    for i in range(n):
        index.insert(f"__bench{i}", "e0")
    t1 = time.perf_counter()
    for i in range(n):
        index.lookup(f"__bench{i}")
    t2 = time.perf_counter()
    for i in range(n):
        index.remove(f"__bench{i}", "e0")
    return {"insert_s": (t1 - t0) / n, "lookup_s": (t2 - t1) / n}


def prls_latency_model(n_nodes: int) -> float:
    """Chervenak et al. P-RLS lookup latency (seconds) vs node count.

    Log-fit through the published 1..15-node points (0.5 ms .. ~3 ms),
    the same extrapolation the paper uses for Figure 2:
        latency_ms ~= 0.5 + 0.74 * ln(n)
    (~3.0ms at 15 nodes, ~15ms at 1M nodes -- matches the text.)
    """
    return (0.5 + 0.74 * math.log(max(n_nodes, 1))) * 1e-3


def prls_aggregate_throughput(n_nodes: int) -> float:
    """Predicted aggregate P-RLS lookups/s (n nodes, each 1/latency)."""
    return n_nodes / prls_latency_model(n_nodes)
