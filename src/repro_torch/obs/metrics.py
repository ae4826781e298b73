"""Live telemetry plane: lock-cheap metrics registry, mergeable snapshots,
periodic JSONL time-series, merged cluster view, and a status endpoint
(DESIGN.md §13).

The registry is the counterpart to `recorder.Recorder`: where the recorder
keeps *per-task lifecycle events* for post-hoc analysis, the registry keeps
*aggregates you can read while the run is alive* -- monotonic counters,
last-write-wins gauges, and fixed-bucket histograms.  The same free-when-off
contract applies: engines hold ``metrics = None`` when the spec doesn't ask
for telemetry, and every hot-path hook is one attribute read plus a branch.
When on, every mutation is one short critical section on the registry's own
leaf lock -- never held across the dispatcher lock, never doing I/O.

Snapshots are plain dicts (JSON-ready) and MERGE: fleet hosts sample their
own registry and ship the snapshot upstream in ``{"t": "stats"}`` frames;
``merge_snapshots`` folds any number of them into a cluster view.  Counters
and histogram buckets add; gauges ALSO add, because every gauge in this
plane is an absolute per-source total (bytes cached on *this* host, tasks
done by *this* host) -- the cluster-wide value of such a gauge is the sum
over sources, never the max or last.
"""
from __future__ import annotations

import json
import socket
import threading
import time
from bisect import bisect_left
from collections import deque
from typing import Iterable, Optional

METRICS_SCHEMA_VERSION = 1

#: default histogram bounds (seconds): log-ish 10us .. 1s + overflow bucket.
#: Tuned for pump/dispatch latencies; callers with other units pass bounds.
LATENCY_BOUNDS_S = (1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3,
                    1e-2, 3e-2, 1e-1, 3e-1, 1.0)


class _Hist:
    """Fixed-bucket histogram: ``counts[i]`` holds observations v with
    ``bounds[i-1] < v <= bounds[i]``; the trailing bucket is overflow."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: tuple):
        if not bounds or list(bounds) != sorted(bounds):
            raise ValueError("histogram bounds must be a sorted, "
                             "non-empty sequence")
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def snapshot(self) -> dict:
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "sum": self.sum, "count": self.count}


class MetricsRegistry:
    """Counters + gauges + histograms behind ONE leaf lock.

    The lock covers single dict updates only; contention is negligible next
    to the dispatcher lock every instrumented path already holds or just
    released.  ``snapshot()`` returns an independent JSON-ready dict."""

    __slots__ = ("_lock", "_counters", "_gauges", "_hists")

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, _Hist] = {}

    # -- write side (hot paths) ---------------------------------------------
    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge_set(self, name: str, v: float) -> None:
        with self._lock:
            self._gauges[name] = v

    def observe(self, name: str, v: float,
                bounds: tuple = LATENCY_BOUNDS_S) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = _Hist(bounds)
            h.observe(v)

    # -- read side ----------------------------------------------------------
    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def gauge(self, name: str) -> float:
        with self._lock:
            return self._gauges.get(name, 0.0)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: h.snapshot()
                               for k, h in self._hists.items()},
            }


# --------------------------------------------------------------------------
# snapshot algebra
# --------------------------------------------------------------------------

def _empty_snapshot() -> dict:
    return {"counters": {}, "gauges": {}, "histograms": {}}


def merge_snapshots(a: dict, b: dict) -> dict:
    """Fold two registry snapshots: counters add, gauges add (they are
    absolute per-source totals -- see module docstring), histogram bucket
    counts/sum/count add.  Merging disjoint observation sets is EXACTLY
    observing their union (test-locked).  Histogram bounds must agree."""
    out = _empty_snapshot()
    for src in (a, b):
        for k, v in src.get("counters", {}).items():
            out["counters"][k] = out["counters"].get(k, 0) + v
        for k, v in src.get("gauges", {}).items():
            out["gauges"][k] = out["gauges"].get(k, 0) + v
        for k, h in src.get("histograms", {}).items():
            cur = out["histograms"].get(k)
            if cur is None:
                out["histograms"][k] = {"bounds": list(h["bounds"]),
                                        "counts": list(h["counts"]),
                                        "sum": h["sum"],
                                        "count": h["count"]}
                continue
            if list(cur["bounds"]) != list(h["bounds"]):
                raise ValueError(f"histogram {k!r}: bounds mismatch, "
                                 f"cannot merge")
            cur["counts"] = [x + y for x, y in zip(cur["counts"],
                                                   h["counts"])]
            cur["sum"] += h["sum"]
            cur["count"] += h["count"]
    return out


def quantile(hist_snap: dict, q: float) -> float:
    """Bucket-resolution quantile estimate: the upper bound of the bucket
    where the cumulative count crosses ``q * count``.  For any observed
    value v the estimate e satisfies prev_bound < v <= e, i.e. the error
    is bounded by one bucket width.  Overflow clamps to the top bound."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must be in [0, 1], got {q}")
    total = hist_snap["count"]
    if total == 0:
        return 0.0
    target = q * total
    cum = 0
    bounds = hist_snap["bounds"]
    for i, c in enumerate(hist_snap["counts"]):
        cum += c
        if cum >= target and c:
            return float(bounds[min(i, len(bounds) - 1)])
    return float(bounds[-1])


# --------------------------------------------------------------------------
# the per-run telemetry bundle
# --------------------------------------------------------------------------

class Telemetry:
    """Everything one observed run carries: the central registry, the
    sampling interval, an optional JSONL sink, the in-memory time series
    (bounded), health events, and an optional `HealthMonitor`.

    Engines store the bundle and hand ``registry`` to the hot paths;
    samplers call :meth:`record_sample` at each tick with the engine's
    clock (virtual time in the sim, wall-rebased time elsewhere)."""

    def __init__(self, interval_s: float = 0.25,
                 sink_path: Optional[str] = None,
                 series_capacity: int = 4096,
                 health=None,
                 registry: Optional[MetricsRegistry] = None):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.registry = registry if registry is not None else MetricsRegistry()
        self.interval_s = float(interval_s)
        self.sink_path = sink_path
        self.series: deque = deque(maxlen=series_capacity)
        self.health = health
        self.health_events: list[dict] = []
        self._sink = None
        self._io_lock = threading.Lock()

    def record_sample(self, t: float, per_host: Optional[dict] = None) -> dict:
        """Snapshot the registry, append to the series, evaluate health
        rules, and (if a sink is configured) append JSONL lines.  Returns
        the sample record."""
        rec = {"kind": "metrics", "t": round(float(t), 6),
               "metrics": self.registry.snapshot()}
        if per_host:
            rec["hosts"] = {h: {"metrics": d.get("metrics", {}),
                                "age_s": d.get("age_s", 0.0)}
                            for h, d in per_host.items()}
        self.series.append(rec)
        events: list[dict] = []
        if self.health is not None:
            events = self.health.observe(rec)
            self.health_events.extend(events)
        if self.sink_path is not None:
            self._write(rec, events)
        return rec

    def merged_last(self) -> dict:
        """Cluster-wide fold of the newest sample: central registry plus
        every per-host snapshot it carried."""
        if not self.series:
            return _empty_snapshot()
        rec = self.series[-1]
        out = merge_snapshots(_empty_snapshot(), rec["metrics"])
        for d in rec.get("hosts", {}).values():
            out = merge_snapshots(out, d.get("metrics", {}))
        return out

    def _write(self, rec: dict, events: Iterable[dict]) -> None:
        with self._io_lock:
            if self._sink is None:
                self._sink = open(self.sink_path, "w")
                header = {"kind": "metrics_header",
                          "schema_version": METRICS_SCHEMA_VERSION,
                          "interval_s": self.interval_s}
                self._sink.write(json.dumps(header) + "\n")
            self._sink.write(json.dumps(rec) + "\n")
            for ev in events:
                self._sink.write(json.dumps(ev) + "\n")
            self._sink.flush()          # monitors tail this file live

    def close(self) -> None:
        with self._io_lock:
            if self._sink is not None:
                self._sink.close()
                self._sink = None


def read_metrics(path) -> tuple[dict, list[dict], list[dict]]:
    """Load a telemetry sink: (header, samples, health events).  Strict on
    the header the same way `recorder.load_events` is."""
    with open(path) as f:
        first = f.readline()
        if not first:
            raise ValueError(f"{path}: empty file, not a metrics sink")
        header = json.loads(first)
        if header.get("kind") != "metrics_header":
            raise ValueError(f"{path}: not a metrics sink")
        if header.get("schema_version") != METRICS_SCHEMA_VERSION:
            raise ValueError(f"{path}: unsupported metrics schema "
                             f"{header.get('schema_version')!r}")
        samples, health = [], []
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            (samples if rec.get("kind") == "metrics" else health).append(rec)
    return header, samples, health


# --------------------------------------------------------------------------
# merged cluster view (central side of the {"t": "stats"} frames)
# --------------------------------------------------------------------------

class ClusterView:
    """Latest per-host registry snapshot, stamped with a receive clock and
    a monotonically increasing sequence number.  The sequence numbers give
    `FleetRuntime.request_stats` its barrier: broadcast a stats request,
    then wait for every live host's seq to advance past the pre-request
    reading -- the frames that arrive after that are post-request samples."""

    def __init__(self):
        self._lock = threading.Lock()
        self._hosts: dict[str, dict] = {}
        self._seq = 0

    def update(self, host_id: str, msg: dict) -> None:
        with self._lock:
            self._seq += 1
            self._hosts[host_id] = {"metrics": msg.get("metrics", {}),
                                    "seq": self._seq,
                                    "recv_clock": time.monotonic()}

    def drop(self, host_id: str) -> None:
        with self._lock:
            self._hosts.pop(host_id, None)

    def seqs(self) -> dict[str, int]:
        with self._lock:
            return {h: d["seq"] for h, d in self._hosts.items()}

    def per_host(self) -> dict[str, dict]:
        now = time.monotonic()
        with self._lock:
            return {h: {"metrics": d["metrics"],
                        "age_s": round(now - d["recv_clock"], 3)}
                    for h, d in self._hosts.items()}

    def merged(self) -> dict:
        with self._lock:
            snaps = [d["metrics"] for d in self._hosts.values()]
        out = _empty_snapshot()
        for s in snaps:
            out = merge_snapshots(out, s)
        return out


# --------------------------------------------------------------------------
# status endpoint (tools/monitor.py --attach)
# --------------------------------------------------------------------------

class TelemetryServer:
    """One-shot TCP status endpoint: each connection receives a single JSON
    line -- the newest sample plus the health-event tail -- and is closed.
    Read-only and stateless per connection, so a monitor polling it can
    never perturb the run beyond one registry snapshot per poll."""

    def __init__(self, telemetry: Telemetry, host: str = "127.0.0.1",
                 port: int = 0):
        self.telemetry = telemetry
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(8)
        self.addr = self._sock.getsockname()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="telemetry-server")
        self._thread.start()

    @property
    def port(self) -> int:
        return self.addr[1]

    def _payload(self) -> bytes:
        tel = self.telemetry
        rec = {"kind": "telemetry",
               "sample": tel.series[-1] if tel.series else None,
               "health": tel.health_events[-20:]}
        return (json.dumps(rec) + "\n").encode()

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            try:
                conn.sendall(self._payload())
            except OSError:
                pass
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=5.0)


def fetch_telemetry(host: str, port: int, timeout: float = 2.0) -> dict:
    """Client half of `TelemetryServer`: one connect, one JSON line."""
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.settimeout(timeout)
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf.decode())
