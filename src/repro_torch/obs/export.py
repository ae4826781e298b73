"""Chrome-trace (chrome://tracing / Perfetto) JSON export.

One track per executor (``ph:"X"`` complete events spanning exec_start ->
exec_end, named by task id), two wait tracks separating *dep-wait* (held on
unmet producers: task_held -> task_ready) from *queue-wait* (runnable but
unplaced: ready/queued -> task_dispatched), plus counter tracks (``ph:"C"``)
for executor pool size, dispatcher queue depth, and cumulative
cache-admitted bytes.  Timestamps are rebased so the trace starts at ts=0
regardless of the emitters' clock bases.

When telemetry ``samples`` (the `repro_torch.obs.metrics.Telemetry` series, or
rows loaded by ``read_metrics``) are passed alongside, the export adds
sampled counter tracks from the live plane: ``sampled_queue_depth``,
``sampled_pool_size``, and cache bytes per host (``sampled_cache_bytes:h0``
on fleets, a single ``sampled_cache_bytes`` track otherwise).  Samples and
events share one rebased timebase, so the sampled curves overlay the
per-task spans.

The port adds two optional inputs.  ``spans``, a recorder's span ring
(``Recorder.spans``), lays each store copy, task function and kernel launch
on its executor's track and each collection pause on a ``host`` track.
``device_ops``, the card's operations as realtime ``(start_ns, end_ns,
name)`` triples (``obs.timeline``), need ``to_epoch_ns`` (the recorder's):
then every timestamp goes through it onto the realtime clock, and the card
gets a process of its own.  Without them the trace is the reference's, byte
for byte.
"""
from __future__ import annotations

import json

from .events import (
    EXEC_END,
    EXEC_START,
    INPUT,
    POOL,
    PUMP,
    SOURCE_LOCAL,
    TASK_DISPATCHED,
    TASK_HELD,
    TASK_QUEUED,
    TASK_READY,
    exec_index,
)

_PID = 0
_COUNTER_TID = 0  # counter tracks render per-process; tid is cosmetic
_DEVICE_PID = 1   # the card's operations (device_ops)


def chrome_trace(events, path=None, samples=None, spans=None,
                 device_ops=None, to_epoch_ns=None):
    """Build a Chrome-trace dict from an event stream (plus optional
    telemetry ``samples``, span ring ``spans`` and card operations
    ``device_ops`` with the recorder's ``to_epoch_ns``); optionally write it
    to ``path``.  Returns the trace dict (``{"traceEvents": [...]}``)."""
    events = sorted(events, key=lambda e: e.get("t", 0.0))
    samples = sorted(samples or [], key=lambda s: s.get("t", 0.0))
    spans = sorted(spans or [], key=lambda s: s["t"])
    device_ops = sorted(device_ops or [])
    if device_ops and to_epoch_ns is None:
        raise ValueError("device_ops need the recorder's to_epoch_ns")
    starts = ([events[0]["t"]] if events else []) \
        + ([samples[0]["t"]] if samples else []) \
        + ([spans[0]["t"]] if spans else [])
    t0 = min(starts) if starts else 0.0

    if device_ops:
        e0 = min(([to_epoch_ns(t0)] if starts else []) + [device_ops[0][0]])

        def us(t):
            return round((to_epoch_ns(t) - e0) / 1e3, 3)
    else:
        def us(t):
            return round((t - t0) * 1e6, 3)

    trace = []
    # Executor tracks, ordered by normalized index.
    eids = sorted({e["eid"] for e in events if e.get("eid") is not None}
                  | {s["eid"] for s in spans if s.get("eid") is not None},
                  key=lambda x: (isinstance(exec_index(x), str),
                                 exec_index(x)))
    tid_of = {eid: i + 1 for i, eid in enumerate(eids)}
    for eid, track in tid_of.items():
        trace.append({"ph": "M", "pid": _PID, "tid": track,
                      "name": "thread_name", "args": {"name": eid}})
    dep_track = len(eids) + 1
    queue_track = len(eids) + 2
    trace.append({"ph": "M", "pid": _PID, "tid": dep_track,
                  "name": "thread_name", "args": {"name": "dep_wait"}})
    trace.append({"ph": "M", "pid": _PID, "tid": queue_track,
                  "name": "thread_name", "args": {"name": "queue_wait"}})

    open_execs: dict = {}
    held_at: dict = {}    # tid -> t of task_held (dep-wait span start)
    queue_at: dict = {}   # tid -> t runnable (ready or first queued)
    cache_bytes = 0
    for e in events:
        k = e["kind"]
        if k == EXEC_START:
            open_execs[e["tid"]] = e
        elif k == EXEC_END:
            s = open_execs.pop(e["tid"], None)
            if s is None:
                continue
            eid = e.get("eid") or s.get("eid")
            trace.append({
                "ph": "X", "pid": _PID, "tid": tid_of.get(eid, 0),
                "name": e["tid"], "cat": "task",
                "ts": us(s["t"]), "dur": max(us(e["t"]) - us(s["t"]), 0.0),
                "args": {"executor": eid},
            })
        elif k == TASK_HELD:
            held_at[e["tid"]] = e["t"]
        elif k == TASK_READY:
            s = held_at.pop(e["tid"], None)
            if s is not None:
                trace.append({
                    "ph": "X", "pid": _PID, "tid": dep_track,
                    "name": e["tid"], "cat": "dep_wait",
                    "ts": us(s), "dur": max(us(e["t"]) - us(s), 0.0),
                })
            queue_at.setdefault(e["tid"], e["t"])
        elif k == TASK_QUEUED:
            queue_at.setdefault(e["tid"], e["t"])
        elif k == TASK_DISPATCHED:
            s = queue_at.pop(e["tid"], None)
            if s is not None:
                trace.append({
                    "ph": "X", "pid": _PID, "tid": queue_track,
                    "name": e["tid"], "cat": "queue_wait",
                    "ts": us(s), "dur": max(us(e["t"]) - us(s), 0.0),
                })
        elif k == POOL:
            trace.append({"ph": "C", "pid": _PID, "tid": _COUNTER_TID,
                          "name": "pool_size", "ts": us(e["t"]),
                          "args": {"executors": e["size"]}})
        elif k == PUMP:
            trace.append({"ph": "C", "pid": _PID, "tid": _COUNTER_TID,
                          "name": "queue_depth", "ts": us(e["t"]),
                          "args": {"tasks": e["queue"]}})
        elif k == INPUT and e.get("source") != SOURCE_LOCAL:
            # Cumulative bytes admitted into caches (peer + store reads both
            # end in a cache admit; local hits move nothing).
            cache_bytes += e.get("bytes", 0)
            trace.append({"ph": "C", "pid": _PID, "tid": _COUNTER_TID,
                          "name": "cache_bytes", "ts": us(e["t"]),
                          "args": {"bytes": cache_bytes}})

    for s in samples:
        ts = us(s.get("t", 0.0))
        g = s.get("metrics", {}).get("gauges", {})
        trace.append({"ph": "C", "pid": _PID, "tid": _COUNTER_TID,
                      "name": "sampled_queue_depth", "ts": ts,
                      "args": {"tasks": g.get("sched.queue_depth", 0)}})
        trace.append({"ph": "C", "pid": _PID, "tid": _COUNTER_TID,
                      "name": "sampled_pool_size", "ts": ts,
                      "args": {"executors": g.get("pool.size", 0)}})
        hosts = s.get("hosts", {})
        if hosts:
            for h in sorted(hosts):
                hg = hosts[h].get("metrics", {}).get("gauges", {})
                trace.append({"ph": "C", "pid": _PID, "tid": _COUNTER_TID,
                              "name": f"sampled_cache_bytes:{h}", "ts": ts,
                              "args": {"bytes": hg.get("cache.bytes", 0)}})
        else:
            trace.append({"ph": "C", "pid": _PID, "tid": _COUNTER_TID,
                          "name": "sampled_cache_bytes", "ts": ts,
                          "args": {"bytes": g.get("cache.bytes", 0)}})

    if spans:
        host_track = queue_track + 1
        trace.append({"ph": "M", "pid": _PID, "tid": host_track,
                      "name": "thread_name", "args": {"name": "host"}})
        for s in spans:
            track = tid_of.get(s.get("eid"), host_track)
            trace.append({
                "ph": "X", "pid": _PID, "tid": track, "name": s["kind"],
                "cat": "span", "ts": us(s["t"]),
                "dur": max(us(s["t"] + s["dur"]) - us(s["t"]), 0.0),
                "args": {k: v for k, v in s.items()
                         if k not in ("t", "dur", "kind")},
            })
    if device_ops:
        trace.append({"ph": "M", "pid": _DEVICE_PID, "tid": 0,
                      "name": "process_name", "args": {"name": "device"}})
        for start, end, name in device_ops:
            trace.append({"ph": "X", "pid": _DEVICE_PID, "tid": 0,
                          "name": name, "cat": "device",
                          "ts": round((start - e0) / 1e3, 3),
                          "dur": max(round((end - start) / 1e3, 3), 0.0)})

    out = {"traceEvents": trace, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(out, fh)
    return out
