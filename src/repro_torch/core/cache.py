"""Per-executor data cache with the paper's four eviction policies (§3.2.2).

Each executor manages its own cache with a *local* eviction policy and
communicates content changes to the dispatcher's central index.  The paper
implements Random, FIFO, LRU and LFU and runs its experiments with LRU; we
implement all four behind one structure.

Invariants (property-tested in tests/test_cache_properties.py):
  * used_bytes == sum(size of resident objects)  and  used_bytes <= capacity
  * an object larger than capacity is never admitted
  * pinned objects (inputs of a running task) are never evicted
  * LRU evicts the least-recently *touched*, FIFO the earliest-inserted,
    LFU the least-frequently-touched (ties broken FIFO), Random any unpinned.
"""
from __future__ import annotations

import enum
import heapq
import random
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Iterable, Optional

from .objects import DataObject


class EvictionPolicy(enum.Enum):
    RANDOM = "random"
    FIFO = "fifo"
    LRU = "lru"
    LFU = "lfu"


@dataclass(slots=True)
class CacheStats:
    hits: int = 0
    misses: int = 0
    insertions: int = 0
    evictions: int = 0
    rejected: int = 0  # objects bigger than the whole cache
    readmits: int = 0  # re-admissions of previously pressure-evicted oids

    @property
    def hit_ratio(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0


class ExecutorCache:
    """Byte-budgeted object cache. Not thread-safe; callers lock."""

    def __init__(
        self,
        capacity_bytes: int,
        policy: EvictionPolicy = EvictionPolicy.LRU,
        seed: int = 0,
    ) -> None:
        if capacity_bytes < 0:
            raise ValueError("capacity must be >= 0")
        self.capacity_bytes = capacity_bytes
        self.policy = policy
        self._rng = random.Random(seed)
        # oid -> size.  Ordering carries policy meaning:
        #   FIFO: insertion order;  LRU: recency order (oldest first).
        self._entries: OrderedDict[str, int] = OrderedDict()
        self._freq: dict[str, int] = {}        # LFU counters
        self._tick = 0                         # LFU FIFO tie-break
        self._order: dict[str, int] = {}       # oid -> insertion tick
        self._pinned: dict[str, int] = {}      # oid -> pin count
        # LFU victim heap of (freq, order, oid), lazily pruned: an entry is
        # stale once the oid's freq moved on (every touch pushes a fresh
        # entry) or the oid left the cache.  Eviction bursts are O(log n)
        # each instead of a full min() scan over the candidate list.
        self._lfu_heap: list[tuple[int, int, str]] = []
        # resident oids in arbitrary order with O(1) swap-remove, so RANDOM
        # eviction samples instead of materializing the candidate list.
        self._resident: list[str] = []
        self._resident_pos: dict[str, int] = {}
        # oids pressure-evicted at least once and not yet re-admitted: a
        # later put() of one of these counts as a re-admit (cache thrash --
        # the working set no longer fits).  Explicit drop()s don't qualify.
        self._evicted_once: set[str] = set()
        self.used_bytes = 0
        self.stats = CacheStats()

    # -- queries ------------------------------------------------------------
    def __contains__(self, oid: str) -> bool:
        return oid in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def contents(self) -> frozenset[str]:
        return frozenset(self._entries)

    def size_of(self, oid: str) -> int:
        return self._entries[oid]

    # -- pinning (inputs of in-flight tasks must not be evicted) ------------
    def pin(self, oid: str) -> None:
        if oid in self._entries:
            self._pinned[oid] = self._pinned.get(oid, 0) + 1

    def unpin(self, oid: str) -> None:
        c = self._pinned.get(oid, 0)
        if c <= 1:
            self._pinned.pop(oid, None)
        else:
            self._pinned[oid] = c - 1

    # -- access -------------------------------------------------------------
    def get(self, oid: str) -> bool:
        """True on hit; updates recency/frequency metadata."""
        if oid not in self._entries:
            self.stats.misses += 1
            return False
        self.stats.hits += 1
        self._touch(oid)
        return True

    def _touch(self, oid: str) -> None:
        if self.policy is EvictionPolicy.LRU:
            self._entries.move_to_end(oid)
        f = self._freq.get(oid, 0) + 1
        self._freq[oid] = f
        if self.policy is EvictionPolicy.LFU:
            self._lfu_push(oid, f)

    def _lfu_push(self, oid: str, freq: int) -> None:
        heapq.heappush(self._lfu_heap, (freq, self._order.get(oid, self._tick), oid))
        if len(self._lfu_heap) > 4 * len(self._entries) + 64:
            self._lfu_heap = [(self._freq[o], self._order[o], o)
                              for o in self._entries]
            heapq.heapify(self._lfu_heap)

    # -- insertion / eviction ------------------------------------------------
    def put(self, obj: DataObject) -> list[str]:
        """Insert (idempotent); returns the list of evicted oids."""
        if obj.oid in self._entries:
            self._touch(obj.oid)
            return []
        if obj.size_bytes > self.capacity_bytes:
            self.stats.rejected += 1
            return []
        evicted: list[str] = []
        while self.used_bytes + obj.size_bytes > self.capacity_bytes:
            victim = self._pick_victim()
            if victim is None:  # everything pinned -- over-admit is forbidden
                self.stats.rejected += 1
                return evicted
            self._remove(victim)
            evicted.append(victim)
            self.stats.evictions += 1
            self._evicted_once.add(victim)
        if obj.oid in self._evicted_once:
            self._evicted_once.discard(obj.oid)
            self.stats.readmits += 1
        self._entries[obj.oid] = obj.size_bytes
        self._freq[obj.oid] = 1
        self._order[obj.oid] = self._tick
        self._tick += 1
        self._resident_pos[obj.oid] = len(self._resident)
        self._resident.append(obj.oid)
        if self.policy is EvictionPolicy.LFU:
            self._lfu_push(obj.oid, 1)
        self.used_bytes += obj.size_bytes
        self.stats.insertions += 1
        return evicted

    def _pick_victim(self) -> Optional[str]:
        if len(self._entries) <= len(self._pinned):
            return None                        # everything resident is pinned
        p = self.policy
        if p is EvictionPolicy.RANDOM:
            # rejection-sample the resident list; pinned objects are few
            # (inputs of running tasks), so this is O(1) expected
            for _ in range(32):
                o = self._resident[self._rng.randrange(len(self._resident))]
                if o not in self._pinned:
                    return o
            candidates = [o for o in self._resident if o not in self._pinned]
            return self._rng.choice(candidates) if candidates else None
        if p in (EvictionPolicy.FIFO, EvictionPolicy.LRU):
            # _entries order is insertion (FIFO) or recency (LRU); first
            # unpinned in order is the victim.
            for o in self._entries:
                if o not in self._pinned:
                    return o
            return None
        # LFU, FIFO tie-break: lazily-pruned min-heap.  Pop stale entries
        # (freq/order moved on, or oid gone); defer valid-but-pinned ones
        # and restore them afterwards.
        deferred: list[tuple[int, int, str]] = []
        victim: Optional[str] = None
        while self._lfu_heap:
            f, ordr, o = heapq.heappop(self._lfu_heap)
            if self._freq.get(o) != f or self._order.get(o) != ordr:
                continue                       # stale: pruned for good
            if o in self._pinned:
                deferred.append((f, ordr, o))
                continue
            victim = o
            deferred.append((f, ordr, o))      # pruned once actually removed
            break
        for item in deferred:
            heapq.heappush(self._lfu_heap, item)
        return victim

    def _remove(self, oid: str) -> None:
        self.used_bytes -= self._entries.pop(oid)
        self._freq.pop(oid, None)
        self._order.pop(oid, None)
        # swap-remove from the resident list
        pos = self._resident_pos.pop(oid)
        last = self._resident.pop()
        if last != oid:
            self._resident[pos] = last
            self._resident_pos[last] = pos

    def drop(self, oid: str) -> bool:
        """Explicit invalidation (executor release / failure handling)."""
        if oid in self._entries and oid not in self._pinned:
            self._remove(oid)
            return True
        return False

    def drop_all(self) -> list[str]:
        dropped = [o for o in list(self._entries) if o not in self._pinned]
        for o in dropped:
            self._remove(o)
        return dropped

    def warm(self, objs: Iterable[DataObject]) -> None:
        """Pre-populate (the paper's 100%-locality warm-cache experiments)."""
        for ob in objs:
            self.put(ob)
