"""The host's spans and the card's operations on one clock.

A recorder's spans (``Recorder.spans``) are stamped on its monotonic clock;
``torch.profiler`` stamps the card's operations in realtime nanoseconds.
``Recorder.to_epoch_ns`` joins the two through the recorder's anchors.  Here
device operations are ``(start_ns, end_ns, name)`` triples on that realtime
clock, as a profiler's kineto events give them (``start_ns()``, plus
``duration_ns()``).
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence


def idle_gaps(ops: Iterable[tuple[int, int, str]],
              t0_ns: Optional[int] = None,
              t1_ns: Optional[int] = None) -> list[tuple[int, int]]:
    """The intervals ``(start_ns, end_ns)`` in which no device operation
    ran: between operations, and from ``t0_ns`` to the first and from the
    last to ``t1_ns`` where those are given.  Operations are clipped to
    ``[t0_ns, t1_ns]``."""
    gaps: list[tuple[int, int]] = []
    reach = t0_ns
    for start, end, _ in sorted(ops):
        if t0_ns is not None and end <= t0_ns:
            continue
        if t1_ns is not None and start >= t1_ns:
            break
        if reach is not None and start > reach:
            gaps.append((reach, start))
        reach = end if reach is None else max(reach, end)
    if t1_ns is not None and reach is not None and reach < t1_ns:
        gaps.append((reach, t1_ns))
    return gaps


def _overlap_ns(a: tuple[int, int], b: tuple[int, int]) -> int:
    return max(0, min(a[1], b[1]) - max(a[0], b[0]))


def _span_intervals(spans: Iterable[dict], to_epoch_ns: Callable[[float], int],
                   kinds: Optional[Sequence[str]] = None
                   ) -> list[tuple[int, int, dict]]:
    """Each span (of ``kinds``, or all) as ``(start_ns, end_ns, span)`` on
    the realtime clock."""
    out = []
    for s in spans:
        if kinds is not None and s["kind"] not in kinds:
            continue
        start = to_epoch_ns(s["t"])
        out.append((start, to_epoch_ns(s["t"] + s["dur"]), s))
    return sorted(out, key=lambda x: x[0])


def name_idle_gaps(ops: Iterable[tuple[int, int, str]], spans: Iterable[dict],
                   to_epoch_ns: Callable[[float], int], n: int = 10,
                   t0_ns: Optional[int] = None,
                   t1_ns: Optional[int] = None) -> list[dict]:
    """The ``n`` longest idle gaps of the card, each named by the host spans
    open across it.  Each is ``{"start_ns", "dur_s", "name", "open"}``:
    ``open`` lists ``(kind, seconds of the gap summed over the spans of that
    kind, spans)``, most seconds first, and ``name`` joins those kinds with
    ``+`` (``"none"`` where no span was open: the host was elsewhere)."""
    gaps = sorted(idle_gaps(ops, t0_ns, t1_ns), key=lambda g: g[0] - g[1])[:n]
    host = _span_intervals(spans, to_epoch_ns)
    out = []
    for g in gaps:
        by_kind: dict[str, list] = {}
        for start, end, s in host:
            if start >= g[1]:
                break
            o = _overlap_ns(g, (start, end))
            if o:
                acc = by_kind.setdefault(s["kind"], [0, 0])
                acc[0] += o
                acc[1] += 1
        open_ = sorted(((k, v[0] * 1e-9, v[1]) for k, v in by_kind.items()),
                       key=lambda x: -x[1])
        out.append({"start_ns": g[0], "dur_s": (g[1] - g[0]) * 1e-9,
                    "name": "+".join(k for k, _, _ in open_) or "none",
                    "open": open_})
    return out
