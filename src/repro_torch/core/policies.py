"""The paper's four task-dispatch policies (§3.2.2).

All policies are pure functions over (task, executor states, index) returning
a :class:`Decision`; the dispatcher in scheduler.py owns queues and state.

  first-available        ignore locality; no location hints shipped.
  first-cache-available  same executor choice; ship index lookups with the
                         task so the executor can peer-fetch instead of
                         hitting the persistent store.
  max-cache-hit          place on the executor caching the most input bytes
                         even if busy (WAIT for it) -- max locality.
  max-compute-util       among AVAILABLE executors pick the one caching the
                         most input bytes -- max utilization.

Scores are *partial-overlap bytes*: for a k-input (join) task every policy
sums the bytes of whichever subset of inputs each executor caches, so an
executor holding 2 of 3 stacked files outranks one holding a single smaller
file -- the overlap-scoring problem §4.3's stacked reads pose (and the win
condition of 0808.3535's data-aware dispatch).  The dispatcher's windowed
max-compute-util path keeps these scores incrementally (scheduler.py §6
invariants); this module stays the pure per-task reference.

``next-available`` (used for the paper's GPFS baseline runs) is an alias of
first-available.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Mapping, Optional, Protocol, Sequence

from .objects import Task


class DispatchPolicy(enum.Enum):
    FIRST_AVAILABLE = "first-available"
    FIRST_CACHE_AVAILABLE = "first-cache-available"
    MAX_CACHE_HIT = "max-cache-hit"
    MAX_COMPUTE_UTIL = "max-compute-util"
    # paper uses this name for the data-unaware GPFS baseline
    NEXT_AVAILABLE = "next-available"

    @property
    def data_aware(self) -> bool:
        return self in (DispatchPolicy.MAX_CACHE_HIT, DispatchPolicy.MAX_COMPUTE_UTIL)

    @property
    def ships_hints(self) -> bool:
        return self is not DispatchPolicy.FIRST_AVAILABLE and self is not DispatchPolicy.NEXT_AVAILABLE


class IndexLike(Protocol):
    def lookup(self, oid: str) -> frozenset[str]: ...


@dataclass(slots=True)
class Decision:
    """Outcome of a placement decision.

    ``executor is None`` and ``wait_for`` set => task must wait for that busy
    executor (max-cache-hit semantics).  ``executor is None`` and ``wait_for``
    None => no executor exists yet (queue stays, provisioner signal).
    """

    executor: Optional[str] = None
    wait_for: Optional[str] = None
    hints: dict[str, tuple[str, ...]] = field(default_factory=dict)
    cached_bytes: int = 0  # bytes of task input the chosen executor caches


def _hints_for(task: Task, index: IndexLike) -> dict[str, tuple[str, ...]]:
    out: dict[str, tuple[str, ...]] = {}
    for oid in task.inputs:
        locs = index.lookup(oid)
        if locs:
            out[oid] = tuple(sorted(locs))
    return out


def _cached_bytes(
    task: Task,
    executor: str,
    hints: Mapping[str, tuple[str, ...]],
    sizes: Mapping[str, int],
) -> int:
    return sum(
        sizes.get(oid, 1)
        for oid, locs in hints.items()
        if executor in locs
    )


def decide(
    policy: DispatchPolicy,
    task: Task,
    available: Sequence[str],
    busy: Sequence[str],
    index: IndexLike,
    sizes: Mapping[str, int],
) -> Decision:
    """Pure placement decision. ``available``/``busy`` are live executors in
    dispatcher arrival order (FIFO -- the paper's 'first available')."""
    if policy in (DispatchPolicy.FIRST_AVAILABLE, DispatchPolicy.NEXT_AVAILABLE):
        if not available:
            return Decision()
        return Decision(executor=available[0])

    hints = _hints_for(task, index)

    if policy is DispatchPolicy.FIRST_CACHE_AVAILABLE:
        if not available:
            return Decision(hints=hints)
        ex = available[0]
        return Decision(executor=ex, hints=hints,
                        cached_bytes=_cached_bytes(task, ex, hints, sizes))

    if policy is DispatchPolicy.MAX_COMPUTE_UTIL:
        if not available:
            return Decision(hints=hints)
        best = max(available,
                   key=lambda ex: (_cached_bytes(task, ex, hints, sizes),))
        return Decision(executor=best, hints=hints,
                        cached_bytes=_cached_bytes(task, best, hints, sizes))

    if policy is DispatchPolicy.MAX_CACHE_HIT:
        everyone = list(available) + list(busy)
        if not everyone:
            return Decision(hints=hints)
        scored = [(_cached_bytes(task, ex, hints, sizes), ex) for ex in everyone]
        best_bytes = max(s for s, _ in scored)
        if best_bytes == 0:
            # nothing cached anywhere: degrade to first-cache-available
            if available:
                ex = available[0]
                return Decision(executor=ex, hints=hints)
            return Decision(hints=hints)
        # prefer an available executor among the best-scoring ones
        best_avail = [ex for s, ex in scored if s == best_bytes and ex in set(available)]
        if best_avail:
            ex = best_avail[0]
            return Decision(executor=ex, hints=hints, cached_bytes=best_bytes)
        # best holder is busy: WAIT for it (the policy's defining behaviour)
        holder = next(ex for s, ex in scored if s == best_bytes)
        return Decision(wait_for=holder, hints=hints, cached_bytes=best_bytes)

    raise ValueError(f"unknown policy {policy}")
