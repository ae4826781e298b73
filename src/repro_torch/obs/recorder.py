"""Bounded, lock-cheap event ring buffer with a JSONL sink.

The Recorder is the only mutable state the observability layer adds to the
hot paths.  Emission is one short critical section on the recorder's OWN
lock (append to a deque + a couple of counter bumps) -- it never takes and
is never held across the dispatcher/runtime lock, and it never does I/O.
When the ring is full the OLDEST event is dropped and counted, so an
under-provisioned ring degrades to a truncated trace, never to backpressure.

Beside the lifecycle stream the port keeps a second ring of timed spans
(``span``/``spans``, kinds in ``events.SPAN_KINDS``), bounded and counted the
same way; ``events``, ``drain``, ``dump`` and ``load_events`` never see it.
A recorder on its own monotonic clock also keeps *anchors*, pairs of
(recorder time, ``time.time_ns()``), so ``to_epoch_ns`` puts a span on the
realtime clock that ``torch.profiler`` stamps the card's operations with.
A request's spans carry its task id through a per-thread request context
(``enter``/``leave``, read with :func:`request`).
"""
from __future__ import annotations

import bisect
import json
import threading
import time
from collections import deque

from .events import EVENT_KINDS, EVENT_SCHEMA_VERSION

DEFAULT_RING_CAPACITY = 65536
#: back-to-back clock reads per anchor; the tightest pair is kept
ANCHOR_READS = 5

_HEADER_KIND = "events_header"


class _Request(threading.local):
    #: (recorder, tid, eid) of the attempt this thread runs, else None
    ctx = None


_REQUEST = _Request()


def request():
    """``(recorder, tid, eid)`` of the request attempt the calling thread
    runs, or None outside one (and always None with recording off)."""
    return _REQUEST.ctx


class Recorder:
    """Bounded event ring.  ``clock`` is a zero-arg callable stamping new
    events; the default is process-relative monotonic seconds (the sim engine
    swaps in its virtual clock, each fleet host builds its own)."""

    __slots__ = ("capacity", "clock", "_buf", "_lock", "emitted", "dropped",
                 "base", "_own_clock", "_spans", "_deferred", "spans_emitted",
                 "spans_dropped", "_anchor_t", "_anchor_ns")

    def __init__(self, capacity: int = DEFAULT_RING_CAPACITY, clock=None):
        if capacity < 1:
            raise ValueError("ring capacity must be >= 1")
        self.capacity = capacity
        #: ``time.monotonic()`` at the recorder's zero (its own clock only)
        self.base = None
        if clock is None:
            t0 = time.monotonic()
            clock = lambda: time.monotonic() - t0  # noqa: E731
            self.base = t0
        self._own_clock = clock if self.base is not None else None
        self.clock = clock
        self._buf: deque = deque()
        self._lock = threading.Lock()
        self.emitted = 0
        self.dropped = 0
        self._spans: deque = deque()
        self._deferred: deque = deque()
        self.spans_emitted = 0
        self.spans_dropped = 0
        self._anchor_t: list[float] = []
        self._anchor_ns: list[int] = []
        self.anchor()

    # -- hot path -----------------------------------------------------------
    def emit(self, kind: str, t: float | None = None, tid=None, eid=None,
             **data) -> None:
        # the kwargs dict doubles as the event record (one allocation)
        data["t"] = self.clock() if t is None else t
        data["kind"] = kind
        if tid is not None:
            data["tid"] = tid
        if eid is not None:
            data["eid"] = eid
        with self._lock:
            if len(self._buf) >= self.capacity:
                self._buf.popleft()
                self.dropped += 1
            self._buf.append(data)
            self.emitted += 1

    def ingest(self, events) -> None:
        """Append pre-stamped events (fleet hosts forward their rings
        upstream; the central recorder ingests the frames verbatim)."""
        with self._lock:
            for ev in events:
                if len(self._buf) >= self.capacity:
                    self._buf.popleft()
                    self.dropped += 1
                self._buf.append(ev)
                self.emitted += 1

    def span(self, kind: str, t: float, dur: float, tid=None, eid=None,
             **data) -> None:
        """Append one timed span (start ``t`` and ``dur`` on the recorder's
        clock) to the span ring; the oldest is dropped and counted when it
        is full."""
        data["kind"] = kind
        data["t"] = t
        data["dur"] = dur
        if tid is not None:
            data["tid"] = tid
        if eid is not None:
            data["eid"] = eid
        with self._lock:
            self._push_span_locked(data)

    def span_nowait(self, kind: str, t: float, dur: float, **data) -> None:
        """``span`` for a collector callback, which may run on a thread that
        holds the recorder's lock (any allocation can start a collection):
        it never waits for the lock.  Where the lock is taken, the span
        joins the ring at the next ``span`` or ``spans``."""
        data["kind"] = kind
        data["t"] = t
        data["dur"] = dur
        if self._lock.acquire(blocking=False):
            try:
                self._push_span_locked(data)
            finally:
                self._lock.release()
        else:
            self._deferred.append(data)

    def _push_span_locked(self, data: dict) -> None:
        while self._deferred:
            self._push_one_locked(self._deferred.popleft())
        self._push_one_locked(data)

    def _push_one_locked(self, data: dict) -> None:
        if len(self._spans) >= self.capacity:
            self._spans.popleft()
            self.spans_dropped += 1
        self._spans.append(data)
        self.spans_emitted += 1

    def enter(self, tid, eid) -> None:
        """Mark the calling thread as running an attempt of ``tid`` on
        ``eid``: spans recorded below the runtime read it with
        :func:`request`."""
        _REQUEST.ctx = (self, tid, eid)

    @staticmethod
    def leave() -> None:
        _REQUEST.ctx = None

    # -- the realtime anchors -----------------------------------------------
    def anchor(self, every: float = 0.0):
        """Record one anchor, ``(recorder time, time.time_ns())``: the
        tightest of ``ANCHOR_READS`` back-to-back reads, the recorder time
        at the middle of its pair.  With ``every`` > 0, only when the last
        anchor is older than that many seconds.  A recorder on a clock not
        its own (a simulated one) takes none.  Returns the anchor or None."""
        clock = self._own_clock
        if clock is None or clock is not self.clock:
            return None
        if every > 0.0 and self._anchor_t \
                and clock() - self._anchor_t[-1] < every:
            return None
        best = None
        for _ in range(ANCHOR_READS):
            a = clock()
            ns = time.time_ns()
            b = clock()
            if best is None or b - a < best[0]:
                best = (b - a, 0.5 * (a + b), ns)
        _, t, ns = best
        with self._lock:
            i = bisect.bisect(self._anchor_t, t)
            self._anchor_t.insert(i, t)
            self._anchor_ns.insert(i, ns)
        return t, ns

    @property
    def anchors(self) -> list[tuple[float, int]]:
        with self._lock:
            return list(zip(self._anchor_t, self._anchor_ns))

    def to_epoch_ns(self, t: float) -> int:
        """Recorder time ``t`` as ``time.time_ns()`` would have read it (the
        timebase of ``torch.profiler``'s events): linear between the anchors
        around ``t``, so a realtime clock slewed during the run is followed;
        offset by the nearest anchor outside them.  Raises on a recorder
        with no anchors (one on a simulated clock)."""
        with self._lock:
            ts, ns = self._anchor_t, self._anchor_ns
            if not ts or self._own_clock is not self.clock:
                raise ValueError("this recorder has no realtime anchors "
                                 "(its clock is not its own monotonic one)")
            i = bisect.bisect(ts, t)
            if i == 0 or i == len(ts):
                j = 0 if i == 0 else len(ts) - 1
                return ns[j] + round((t - ts[j]) * 1e9)
            t0, t1, n0, n1 = ts[i - 1], ts[i], ns[i - 1], ns[i]
        return n0 + round((t - t0) * (n1 - n0) / (t1 - t0))

    # -- cold path ----------------------------------------------------------
    def spans(self) -> list:
        """Non-destructive snapshot of the span ring."""
        with self._lock:
            while self._deferred:
                self._push_one_locked(self._deferred.popleft())
            return list(self._spans)

    def drain(self) -> list:
        """Remove and return all buffered events (wire forwarding)."""
        with self._lock:
            evs = list(self._buf)
            self._buf.clear()
        return evs

    def events(self) -> list:
        """Non-destructive snapshot of the buffered events."""
        with self._lock:
            return list(self._buf)

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def dump(self, path) -> int:
        """Write the buffered events as JSONL (one header line with schema
        version + drop accounting, then one event per line).  Returns the
        number of event lines written."""
        evs = self.events()
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(json.dumps({
                "kind": _HEADER_KIND,
                "schema_version": EVENT_SCHEMA_VERSION,
                "n_events": len(evs),
                "emitted": self.emitted,
                "dropped": self.dropped,
            }, sort_keys=True) + "\n")
            for ev in evs:
                fh.write(json.dumps(ev, sort_keys=True) + "\n")
        return len(evs)


def load_events(path):
    """Read a Recorder JSONL sink back: ``(header, events)``.  Hard-errors on
    unknown header kinds/versions, on unknown event kinds, and on truncated
    files -- a half-understood sink silently skews everything downstream."""
    with open(path, "r", encoding="utf-8") as fh:
        header = json.loads(fh.readline())
        if header.get("kind") != _HEADER_KIND:
            raise ValueError(f"not an events sink: header kind "
                             f"{header.get('kind')!r}")
        if header.get("schema_version") != EVENT_SCHEMA_VERSION:
            raise ValueError(
                f"unsupported event schema version "
                f"{header.get('schema_version')!r} "
                f"(supported: {EVENT_SCHEMA_VERSION})")
        events = [json.loads(line) for line in fh if line.strip()]
    if len(events) != header["n_events"]:
        raise ValueError(f"truncated events sink: header says "
                         f"{header['n_events']} events, found {len(events)}")
    for i, ev in enumerate(events):
        if ev.get("kind") not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {ev.get('kind')!r} "
                             f"at event {i} (schema v{EVENT_SCHEMA_VERSION})")
    return header, events
