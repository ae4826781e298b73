"""Core data model for data diffusion.

The paper's execution model (§3.2.2): data objects are *immutable after
creation* -- this is the assumption that lets diffusion avoid cache-coherence
protocols entirely and keep only a loosely-coherent location index.  We encode
immutability by making :class:`DataObject` frozen and giving the system no
mutation API at all: objects are created (by the store or by task outputs) and
replicated, never rewritten.
"""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

# ---------------------------------------------------------------------------
# Data objects
# ---------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class DataObject:
    """An immutable, replicable unit of data (a file in the paper)."""

    oid: str
    size_bytes: int

    def __post_init__(self) -> None:
        if self.size_bytes < 0:
            raise ValueError(f"negative size for {self.oid}")


class TaskState(enum.Enum):
    SUBMITTED = "submitted"      # in the dispatcher wait queue
    PENDING = "pending"          # bound to a busy executor (max-cache-hit waits)
    DISPATCHED = "dispatched"    # sent to an executor, not yet running
    FETCHING = "fetching"        # executor staging inputs
    RUNNING = "running"          # compute phase
    DONE = "done"
    FAILED = "failed"            # will be retried unless attempts exhausted


_task_counter = itertools.count()


@dataclass(slots=True)
class Task:
    """A unit of work reading immutable inputs and creating new objects.

    ``compute_seconds`` drives the discrete-event simulator; ``fn`` drives the
    real threaded runtime (both may be set -- the runtime ignores
    ``compute_seconds`` and the simulator ignores ``fn``).
    """

    inputs: tuple[str, ...]
    outputs: tuple[DataObject, ...] = ()
    compute_seconds: float = 0.0
    fn: Optional[Callable[..., Any]] = None
    # metadata-operation count against the persistent store (the paper's
    # "wrapper" sandbox: mkdir + symlink + rmdir = 3 metadata ops per task).
    store_metadata_ops: int = 0
    tid: str = field(default_factory=lambda: f"t{next(_task_counter)}")
    tag: Any = None
    # tids of producer tasks that must complete before this task may run.
    # The dispatcher holds tasks with unmet deps out of the queue entirely.
    deps: tuple[str, ...] = ()

    # -- mutable bookkeeping (owned by the dispatcher) ----------------------
    state: TaskState = TaskState.SUBMITTED
    executor: Optional[str] = None
    attempts: int = 0
    max_attempts: int = 3
    submit_time: float = 0.0
    # when the task became runnable: == submit_time for dep-free tasks,
    # stamped at release for tasks that waited on producers.
    ready_time: float = 0.0
    dispatch_time: float = 0.0
    start_time: float = 0.0
    end_time: float = 0.0
    # filled by the dispatcher for cache-aware policies: oid -> executors
    # known (at dispatch time) to cache it.  first-available ships none.
    location_hints: dict[str, tuple[str, ...]] = field(default_factory=dict)
    # byte ledger filled in by whoever executed the task.  Multi-input
    # (join) tasks accumulate one entry per input: ``cache_hits`` counts
    # local-cache inputs, ``peer_hits`` inputs served cache-to-cache, and
    # ``cache_misses`` inputs not found locally (peer + store) -- so
    # ``cache_misses - peer_hits`` inputs touched the persistent store.
    bytes_local: int = 0
    bytes_cache_to_cache: int = 0
    bytes_store: int = 0
    cache_hits: int = 0
    peer_hits: int = 0
    cache_misses: int = 0
    result: Any = None

    def reset_for_retry(self) -> None:
        self.state = TaskState.SUBMITTED
        self.executor = None
        self.location_hints = {}
        self.bytes_local = self.bytes_cache_to_cache = self.bytes_store = 0
        self.cache_hits = self.peer_hits = self.cache_misses = 0


def make_objects(prefix: str, n: int, size_bytes: int) -> list[DataObject]:
    """Convenience: n equally-sized immutable objects."""
    return [DataObject(f"{prefix}{i}", size_bytes) for i in range(n)]


def uniform_tasks(
    objects: Sequence[DataObject],
    accesses_per_object: int = 1,
    compute_seconds: float = 0.0,
    store_metadata_ops: int = 0,
) -> list[Task]:
    """One task per (object, access) -- the microbenchmark workload shape."""
    tasks = []
    for _ in range(accesses_per_object):
        for ob in objects:
            tasks.append(
                Task(
                    inputs=(ob.oid,),
                    compute_seconds=compute_seconds,
                    store_metadata_ops=store_metadata_ops,
                )
            )
    return tasks
