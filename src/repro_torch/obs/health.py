"""Health evaluator: window rules over the telemetry sample stream
(DESIGN.md §13).

`HealthMonitor.observe(sample)` is called once per recorded sample (the
`Telemetry` bundle wires it in) and returns the health events that FIRED on
this sample.  Rules are edge-triggered: an event is emitted when a rule's
condition transitions inactive -> active, suppressed while it stays active,
and re-armed when the condition clears -- so a sustained backlog produces
one event, not one per tick.

Built-in rules (each keyed (rule, host) in the active set):

  backlog_growth    the merged ``sched.queue_depth`` gauge rose strictly
                    across the whole window and the newest reading is at
                    least ``backlog_min`` -- the queue is growing faster
                    than the pool drains it;
  stale_heartbeat   a host's stats frame is older than ``stale_after_s``
                    (only meaningful on engines that attach receive ages,
                    i.e. fleets);
  cache_thrash      the merged ``cache.readmits`` total (re-admissions of
                    objects previously pressure-evicted) grew by at least
                    ``thrash_min`` across the window -- the working set no
                    longer fits and the cache is churning;
  recorder_drops    the merged ``obs.recorder_dropped`` total increased:
                    the lifecycle ring is saturated and the trace (hence
                    any divergence join) is silently truncated.

Events are plain dicts: ``{"kind": "health", "t", "rule", "severity",
"host", "detail"}`` -- JSONL-ready, appended to the telemetry sink right
after the sample that triggered them.
"""
from __future__ import annotations

from collections import deque
from typing import Optional


def merged_value(sample: dict, name: str) -> float:
    """A metric's cluster-wide value in one sample: central counter+gauge
    reading plus the same reading from every attached per-host snapshot
    (gauges in this plane are absolute per-source totals, so sum)."""
    def _one(snap: dict) -> float:
        return (snap.get("counters", {}).get(name, 0)
                + snap.get("gauges", {}).get(name, 0))
    total = _one(sample.get("metrics", {}))
    for d in sample.get("hosts", {}).values():
        total += _one(d.get("metrics", {}))
    return total


class HealthMonitor:
    def __init__(self, window: int = 5, backlog_min: int = 8,
                 stale_after_s: float = 2.0, thrash_min: int = 16):
        if window < 2:
            raise ValueError(f"window must be >= 2, got {window}")
        self.window = window
        self.backlog_min = backlog_min
        self.stale_after_s = stale_after_s
        self.thrash_min = thrash_min
        self._samples: deque = deque(maxlen=window)
        self._active: set[tuple] = set()

    # -- rule conditions ----------------------------------------------------
    def _backlog_growth(self) -> Optional[str]:
        if len(self._samples) < self.window:
            return None
        depths = [merged_value(s, "sched.queue_depth")
                  for s in self._samples]
        if depths[-1] < self.backlog_min:
            return None
        if all(b > a for a, b in zip(depths, depths[1:])):
            return (f"queue depth rose {depths[0]:.0f} -> {depths[-1]:.0f} "
                    f"over {len(depths)} samples")
        return None

    def _cache_thrash(self) -> Optional[str]:
        if len(self._samples) < self.window:
            return None
        delta = (merged_value(self._samples[-1], "cache.readmits")
                 - merged_value(self._samples[0], "cache.readmits"))
        if delta >= self.thrash_min:
            return (f"{delta:.0f} re-admissions of evicted objects over "
                    f"{len(self._samples)} samples")
        return None

    def _recorder_drops(self) -> Optional[str]:
        if len(self._samples) < 2:
            return None
        cur = merged_value(self._samples[-1], "obs.recorder_dropped")
        prev = merged_value(self._samples[-2], "obs.recorder_dropped")
        if cur > prev:
            return (f"lifecycle ring dropped {cur:.0f} events total "
                    f"(+{cur - prev:.0f}); trace is truncated")
        return None

    def _stale_hosts(self, sample: dict) -> dict[str, str]:
        out = {}
        for host, d in sample.get("hosts", {}).items():
            age = d.get("age_s", 0.0)
            if age > self.stale_after_s:
                out[host] = f"last stats frame {age:.1f}s ago"
        return out

    # -- feeding samples ----------------------------------------------------
    def observe(self, sample: dict) -> list[dict]:
        """Feed one sample; returns newly-fired events (edge-triggered)."""
        self._samples.append(sample)
        t = sample.get("t", 0.0)
        fired: list[dict] = []

        def edge(rule: str, host, severity: str, detail: Optional[str]):
            key = (rule, host)
            if detail is None:
                self._active.discard(key)
                return
            if key in self._active:
                return
            self._active.add(key)
            fired.append({"kind": "health", "t": t, "rule": rule,
                          "severity": severity, "host": host,
                          "detail": detail})

        edge("backlog_growth", None, "warn", self._backlog_growth())
        edge("cache_thrash", None, "warn", self._cache_thrash())
        edge("recorder_drops", None, "error", self._recorder_drops())
        stale = self._stale_hosts(sample)
        for host in list(sample.get("hosts", {})) or []:
            edge("stale_heartbeat", host, "error", stale.get(host))
        return fired
