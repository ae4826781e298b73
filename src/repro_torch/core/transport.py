"""Byte-accounting transport fabric for the discrete-event simulator.

Fluid-flow model: every transfer is a Flow crossing one or more
BandwidthResources (store ports, node disks, NICs, a per-flow protocol cap
standing in for the paper's per-executor GridFTP server).  A flow's
instantaneous rate is

    rate(f) = min over r in f.resources of  capacity(r) / nflows(r)

recomputed whenever any flow starts or finishes.  This equal-share rule is
conservative w.r.t. max-min fairness (never oversubscribes a resource, may
under-fill one when a flow is bottlenecked elsewhere) and is deterministic,
which we value more than the last few percent of model fidelity.  Calibration
constants live in testbeds.py.

Rebalancing is *incremental* (``solver="incremental"``, the default): a flow
start/finish/cancel only reprices flows sharing a resource whose flow count
changed, and a flow whose rate is unchanged keeps its generation and its
already-scheduled completion event.  The O(F)-scan-per-event reference
implementation is retained as ``solver="naive"`` — it produces bit-identical
results because both solvers advance a flow's byte clock only at rate
changes, from the same float anchors.

MetadataService models the persistent store's metadata path (file open,
mkdir/symlink/rmdir for the paper's sandbox wrapper) as a single FIFO server
with fixed per-op latency -- this is what produces the paper's ~21 tasks/s
small-file wrapper floor (Figure 5).

Counterpart of ``repro.core.transport``: the same event order, float for
float, so the simulator's reports equal the reference's.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

EPS = 1e-12


class BandwidthResource:
    __slots__ = ("name", "capacity", "flows")

    def __init__(self, name: str, capacity_bytes_per_s: float) -> None:
        self.name = name
        self.capacity = float(capacity_bytes_per_s)
        self.flows: set[int] = set()

    def __repr__(self) -> str:  # pragma: no cover
        return f"<BW {self.name} {self.capacity:.3g}B/s x{len(self.flows)}>"


@dataclass(slots=True)
class Flow:
    fid: int
    size: float
    resources: tuple[BandwidthResource, ...]
    on_done: Callable[[float], None]
    kind: str = ""
    # (done, last_t, rate) is an *anchor*: done is exact as of last_t and the
    # flow progresses at ``rate`` since.  The anchor moves only when the rate
    # changes -- this is what keeps the two solvers float-identical.
    done: float = 0.0
    rate: float = 0.0
    last_t: float = 0.0
    gen: int = 0          # invalidates stale completion events
    alive: bool = True
    t_start: float = 0.0


@dataclass(order=True, slots=True)
class _Event:
    t: float
    seq: int
    fn: Callable[[float], None] = field(compare=False)


class EventLoop:
    """Deterministic discrete-event loop (time, insertion-order tie-break)."""

    def __init__(self) -> None:
        self._heap: list[_Event] = []
        self._seq = itertools.count()
        self.now = 0.0
        self.n_scheduled = 0   # total heap pushes (engine-cost observability)
        self.n_fired = 0

    def at(self, t: float, fn: Callable[[float], None]) -> None:
        self.n_scheduled += 1
        heapq.heappush(self._heap, _Event(max(t, self.now), next(self._seq), fn))

    def after(self, dt: float, fn: Callable[[float], None]) -> None:
        self.at(self.now + max(dt, 0.0), fn)

    def run(self, until: float = float("inf")) -> float:
        while self._heap and self._heap[0].t <= until:
            ev = heapq.heappop(self._heap)
            self.now = ev.t
            self.n_fired += 1
            ev.fn(ev.t)
        return self.now

    @property
    def empty(self) -> bool:
        return not self._heap


class FlowNetwork:
    """Manages fluid flows over shared resources on an EventLoop.

    ``solver``:
      * ``"incremental"`` (default) -- dirty-resource propagation: only flows
        sharing a resource whose flow count changed are repriced, and an ETA
        event is (re)scheduled only when the rate actually changed.
      * ``"naive"`` -- the retained reference: every rebalance scans every
        live flow and re-pushes its ETA event (the O(F²) event storm).  Kept
        as the reference the incremental solver must equal.
    """

    def __init__(self, loop: EventLoop, solver: str = "incremental") -> None:
        if solver not in ("incremental", "naive"):
            raise ValueError(f"unknown flow solver {solver!r}")
        self.loop = loop
        self.solver = solver
        self._flows: dict[int, Flow] = {}
        self._fid = itertools.count()
        # byte ledger: kind -> bytes completed
        self.bytes_by_kind: dict[str, float] = {}
        self.flow_log: list[tuple[float, float, float, str]] = []  # (t0, t1, bytes, kind)
        # engine-cost observability
        self.n_rebalances = 0
        self.n_rate_recomputes = 0
        self.n_events_scheduled = 0
        self.n_event_skips = 0         # repriced but rate unchanged: no push

    # -- public API -----------------------------------------------------------
    def start(
        self,
        size_bytes: float,
        resources: tuple[BandwidthResource, ...],
        on_done: Callable[[float], None],
        kind: str = "",
        flow_cap: Optional[float] = None,
    ) -> int:
        """Start a flow; on_done(now) fires at completion. Zero-size flows
        complete immediately (still via the loop, preserving event order)."""
        fid = next(self._fid)
        if flow_cap is not None:
            resources = resources + (BandwidthResource(f"flowcap{fid}", flow_cap),)
        f = Flow(fid=fid, size=float(size_bytes), resources=resources,
                 on_done=on_done, kind=kind, last_t=self.loop.now,
                 t_start=self.loop.now)
        if f.size <= EPS:
            self.loop.after(0.0, lambda t, f=f: self._finish(f, t))
            return fid
        self._flows[fid] = f
        for r in f.resources:
            r.flows.add(fid)
        self._rebalance(f.resources)
        return fid

    def cancel(self, fid: int) -> None:
        f = self._flows.pop(fid, None)
        if f is None:
            return
        f.alive = False
        for r in f.resources:
            r.flows.discard(f.fid)
        self._rebalance(f.resources)

    @property
    def live_flows(self) -> int:
        return len(self._flows)

    # -- internals --------------------------------------------------------------
    def _rebalance(self, dirty: Iterable[BandwidthResource]) -> None:
        """Reprice flows after the flow count of ``dirty`` resources changed."""
        self.n_rebalances += 1
        if self.solver == "naive":
            self._rebalance_naive()
            return
        now = self.loop.now
        # Dirty-resource worklist.  Under equal-share, a flow's rate depends
        # only on the flow counts of its own resources, and repricing never
        # changes a count -- so the fixed point is reached after one wave and
        # the worklist never grows.  (A max-min refinement would append a
        # flow's other resources when its rate drops below their fair share.)
        affected: set[int] = set()
        for r in dirty:
            affected |= r.flows
        # ascending fid == _flows insertion order == the naive scan order,
        # so same-timestamp completion events pop identically in both solvers
        for fid in sorted(affected):
            f = self._flows.get(fid)
            if f is not None:
                self._reprice(f, now)

    def _rebalance_naive(self) -> None:
        """Reference solver: global scan, unconditional ETA re-push."""
        now = self.loop.now
        for f in self._flows.values():
            self._reprice(f, now, always_push=True)

    def _reprice(self, f: Flow, now: float, always_push: bool = False) -> None:
        self.n_rate_recomputes += 1
        new_rate = min(r.capacity / max(len(r.flows), 1) for r in f.resources)
        if new_rate != f.rate:
            # advance the byte clock to `now` and move the anchor; the
            # previously scheduled event (old gen) becomes stale
            f.done += f.rate * (now - f.last_t)
            f.last_t = now
            f.rate = new_rate
            f.gen += 1
            self._push_eta(f)
        elif always_push:
            # naive mode re-pushes a duplicate of the live event (same
            # anchor => same eta float, later heap seq => pops after it)
            self._push_eta(f)
        else:
            self.n_event_skips += 1

    def _push_eta(self, f: Flow) -> None:
        remaining = max(f.size - f.done, 0.0)
        eta = f.last_t + (remaining / f.rate if f.rate > EPS else float("inf"))
        if eta != float("inf"):
            self.n_events_scheduled += 1
            gen = f.gen
            self.loop.at(eta, lambda t, f=f, g=gen: self._maybe_finish(f, g, t))

    def _maybe_finish(self, f: Flow, gen: int, now: float) -> None:
        if not f.alive or f.gen != gen or f.fid not in self._flows:
            return
        # gen matches => no repricing occurred since this ETA was computed,
        # so the rate has been constant and the flow is exactly done now
        # (modulo float drift, which we therefore clamp away).
        f.done = f.size
        f.last_t = now
        del self._flows[f.fid]
        for r in f.resources:
            r.flows.discard(f.fid)
        self._rebalance(f.resources)
        self._finish(f, now)

    def _finish(self, f: Flow, now: float) -> None:
        f.alive = False
        self.bytes_by_kind[f.kind] = self.bytes_by_kind.get(f.kind, 0.0) + f.size
        self.flow_log.append((f.t_start, now, f.size, f.kind))
        f.on_done(now)


class MetadataService:
    """FIFO metadata server: per-op latency, one op at a time (GPFS MDS)."""

    def __init__(self, loop: EventLoop, op_latency_s: float) -> None:
        self.loop = loop
        self.op_latency = op_latency_s
        self._next_free = 0.0
        self.n_ops = 0

    def submit(self, n_ops: int, on_done: Callable[[float], None]) -> None:
        if n_ops <= 0 or self.op_latency <= 0:
            self.loop.after(0.0, on_done)
            return
        start = max(self.loop.now, self._next_free)
        end = start + n_ops * self.op_latency
        self._next_free = end
        self.n_ops += n_ops
        self.loop.at(end, on_done)


class FifoServer:
    """Serialized service with fixed per-item time (dispatcher CPU model)."""

    def __init__(self, loop: EventLoop, service_time_s: float) -> None:
        self.loop = loop
        self.service_time = service_time_s
        self._next_free = 0.0
        self.n_served = 0

    def submit(self, on_done: Callable[[float], None], cost_s: Optional[float] = None) -> None:
        cost = self.service_time if cost_s is None else cost_s
        start = max(self.loop.now, self._next_free)
        end = start + cost
        self._next_free = end
        self.n_served += 1
        self.loop.at(end, on_done)
