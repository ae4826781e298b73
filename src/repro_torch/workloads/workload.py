"""Workload = arrival process x popularity model -> timed task events.

A :class:`Workload` is an immutable list of :class:`TaskEvent` (arrival
time + task shape) over an object catalog.  Engines consume it through
``tasks()``, which materialises *fresh* :class:`repro_torch.core.objects.Task`
instances on every call -- the events themselves are never mutated, so one
Workload can be run many times (and across both engines) with identical
inputs.  Task ids are assigned deterministically (``{name}-{i}``), never
from the global task counter, so a recorded trace replays with the same
ids (trace.py round-trips bit-identically).

Invariants (relied on by the simulator's ARRIVAL events, the runtime's
paced submitter, and the trace tests):
  * events are sorted by arrival time (ties keep generation order);
  * every input oid appears in ``objects``;
  * generation is a pure function of (generator specs, seed, n_tasks).

Tasks may read *multiple* inputs (k-input "joins" -- the §4.3 stacked
reads); ``TaskEvent.inputs`` is the ordered tuple of oids and
``mean_inputs_per_task`` exposes the join width.  Single-input workloads
are unchanged.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Sequence

from repro_torch.core.objects import DataObject, Task

from .arrivals import ArrivalProcess
from .popularity import PopularityModel


@dataclass(frozen=True, slots=True)
class TaskEvent:
    """One open-loop arrival: at time ``t`` a task with this shape arrives."""

    t: float
    tid: str
    inputs: tuple[str, ...]
    outputs: tuple[tuple[str, int], ...] = ()   # (oid, size_bytes)
    compute_seconds: float = 0.0
    store_metadata_ops: int = 0
    # producer tids that must complete before this task becomes ready.
    # () (the default) keeps the classic flat-bag shape.
    deps: tuple[str, ...] = ()

    def make_task(self) -> Task:
        return Task(
            inputs=self.inputs,
            outputs=tuple(DataObject(oid, sz) for oid, sz in self.outputs),
            compute_seconds=self.compute_seconds,
            store_metadata_ops=self.store_metadata_ops,
            tid=self.tid,
            deps=self.deps,
        )


class Workload:
    """An immutable timed-task sequence over an object catalog."""

    def __init__(self, name: str, objects: Sequence[DataObject],
                 events: Sequence[TaskEvent], spec: Optional[dict] = None) -> None:
        ts = [e.t for e in events]
        if any(b < a for a, b in zip(ts, ts[1:])):
            raise ValueError("workload events must be sorted by arrival time")
        tids = set()
        for e in events:
            if e.tid in tids:
                raise ValueError(f"duplicate task id {e.tid!r}")
            tids.add(e.tid)
        # Produced oids must be globally unique AND disjoint from the catalog:
        # a second registration of the same oid would silently clobber the
        # size table / index state for the first (objects are immutable).
        catalog = {ob.oid for ob in objects}
        produced: dict[str, str] = {}   # oid -> producing tid
        for e in events:
            for oid, _sz in e.outputs:
                if oid in catalog:
                    raise ValueError(
                        f"event {e.tid} produces {oid!r}, which collides "
                        f"with a catalog object")
                other = produced.get(oid)
                if other is not None:
                    raise ValueError(
                        f"events {other} and {e.tid} both produce {oid!r} "
                        f"(produced oids must be unique)")
                produced[oid] = e.tid
        # Inputs may read catalog objects or another task's produced outputs
        # (stage-structured pipelines); anything else is unknown.
        known = catalog | set(produced)
        for e in events:
            missing = [oid for oid in e.inputs if oid not in known]
            if missing:
                raise ValueError(f"event {e.tid} reads unknown objects {missing}")
        _validate_deps(events, tids)
        self.name = name
        self.objects: tuple[DataObject, ...] = tuple(objects)
        self.events: tuple[TaskEvent, ...] = tuple(events)
        self.spec = dict(spec or {})

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self) -> Iterator[tuple[float, Task]]:
        for e in self.events:
            yield e.t, e.make_task()

    def tasks(self) -> list[tuple[float, Task]]:
        """Fresh Task objects for one run (engines mutate Task state)."""
        return [(e.t, e.make_task()) for e in self.events]

    @property
    def duration(self) -> float:
        """Arrival span (time of the last arrival)."""
        return self.events[-1].t if self.events else 0.0

    def offered_load(self) -> float:
        """Mean arrival rate over the arrival span (tasks/s)."""
        return len(self.events) / self.duration if self.duration > 0 else 0.0

    def mean_inputs_per_task(self) -> float:
        """Mean join width k (1.0 for classic single-input workloads)."""
        if not self.events:
            return 0.0
        return sum(len(e.inputs) for e in self.events) / len(self.events)

    def has_deps(self) -> bool:
        """True if any task carries dependency edges (a DAG workload)."""
        return any(e.deps for e in self.events)


def _validate_deps(events: Sequence[TaskEvent], tids: set) -> None:
    """Reject unknown-tid deps, self-deps, and dependency cycles."""
    dag = False
    for e in events:
        for d in e.deps:
            if d == e.tid:
                raise ValueError(f"event {e.tid} depends on itself")
            if d not in tids:
                raise ValueError(f"event {e.tid} depends on unknown task {d!r}")
        dag = dag or bool(e.deps)
    if not dag:
        return
    # Kahn's algorithm over the dep edges; leftover nodes => a cycle.
    indeg = {e.tid: len(set(e.deps)) for e in events}
    dependents: dict[str, list[str]] = {}
    for e in events:
        for d in set(e.deps):
            dependents.setdefault(d, []).append(e.tid)
    ready = [tid for tid, n in indeg.items() if n == 0]
    seen = 0
    while ready:
        tid = ready.pop()
        seen += 1
        for dtid in dependents.get(tid, ()):
            indeg[dtid] -= 1
            if indeg[dtid] == 0:
                ready.append(dtid)
    if seen != len(events):
        stuck = sorted(tid for tid, n in indeg.items() if n > 0)[:5]
        raise ValueError(f"dependency cycle among tasks {stuck}")


def generate(
    name: str,
    arrivals: ArrivalProcess,
    popularity: PopularityModel,
    n_tasks: int,
    *,
    objects: Optional[Sequence[DataObject]] = None,
    n_objects: int = 0,
    object_bytes: int = 0,
    compute_seconds: float | Callable[[int, random.Random], float] = 0.0,
    output_bytes: int = 0,
    store_metadata_ops: int = 0,
    seed: int = 0,
) -> Workload:
    """Compose an arrival process and a popularity model into a Workload.

    Pass either an explicit ``objects`` catalog or (``n_objects``,
    ``object_bytes``) to synthesise one.  ``compute_seconds`` may be a
    constant or a callable ``(task_index, rng) -> seconds`` for heavy-tailed
    service times.  Everything is a pure function of ``seed``.
    """
    if objects is None:
        if n_objects <= 0:
            raise ValueError("need objects or n_objects > 0")
        objects = [DataObject(f"{name}.o{i}", object_bytes)
                   for i in range(n_objects)]
    objects = list(objects)
    rng = random.Random(seed ^ 0x9E3779B9)   # decorrelated from arrival draws
    events: list[TaskEvent] = []
    for i, t in enumerate(arrivals.times(n_tasks, seed)):
        idx = popularity.pick(i, rng, len(objects))
        cs = compute_seconds(i, rng) if callable(compute_seconds) \
            else compute_seconds
        outputs = ((f"{name}-{i}.out", output_bytes),) if output_bytes > 0 else ()
        events.append(TaskEvent(
            t=t,
            tid=f"{name}-{i}",
            inputs=tuple(objects[j].oid for j in idx),
            outputs=outputs,
            compute_seconds=cs,
            store_metadata_ops=store_metadata_ops,
        ))
    spec = {
        "name": name,
        "seed": seed,
        "n_tasks": n_tasks,
        "arrivals": arrivals.spec(),
        "popularity": popularity.spec(),
        "object_bytes": object_bytes,
        "output_bytes": output_bytes,
        "store_metadata_ops": store_metadata_ops,
    }
    return Workload(name, objects, events, spec)
