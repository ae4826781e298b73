"""Bounded, lock-cheap event ring buffer with a JSONL sink.

The Recorder is the only mutable state the observability layer adds to the
hot paths.  Emission is one short critical section on the recorder's OWN
lock (append to a deque + a couple of counter bumps) -- it never takes and
is never held across the dispatcher/runtime lock, and it never does I/O.
When the ring is full the OLDEST event is dropped and counted, so an
under-provisioned ring degrades to a truncated trace, never to backpressure.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque

from .events import EVENT_KINDS, EVENT_SCHEMA_VERSION

DEFAULT_RING_CAPACITY = 65536

_HEADER_KIND = "events_header"


class Recorder:
    """Bounded event ring.  ``clock`` is a zero-arg callable stamping new
    events; the default is process-relative monotonic seconds (the sim engine
    swaps in its virtual clock, each fleet host builds its own)."""

    __slots__ = ("capacity", "clock", "_buf", "_lock", "emitted", "dropped")

    def __init__(self, capacity: int = DEFAULT_RING_CAPACITY, clock=None):
        if capacity < 1:
            raise ValueError("ring capacity must be >= 1")
        self.capacity = capacity
        if clock is None:
            t0 = time.monotonic()
            clock = lambda: time.monotonic() - t0  # noqa: E731
        self.clock = clock
        self._buf: deque = deque()
        self._lock = threading.Lock()
        self.emitted = 0
        self.dropped = 0

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

    # -- cold path ----------------------------------------------------------
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
