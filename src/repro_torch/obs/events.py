"""Versioned task-lifecycle event schema.

An event is a plain dict -- ``{"t": <seconds>, "kind": <str>}`` plus optional
``tid`` (task id), ``eid`` (executor id) and kind-specific fields.  Both
engines emit the SAME kinds at the same lifecycle points, so a
batch-synchronous replay produces identical per-task event sequences on the
simulator and on the threaded runtime (tests/test_torch_obs.py asserts
this).

Clocks differ by emitter (sim time for DiffusionSim, process-relative
monotonic for the runtime); comparisons that must be exact therefore go
through :func:`lifecycle_fingerprints`, which drops timestamps and
normalizes executor naming (sim ``e3`` vs runtime ``w3``).

A copy of the reference's ``repro.obs.events``: the same schema version,
kinds and outcome fields, so event sinks and v3 traces read across the two
packages.  The lease/claim kinds stay in the schema; only a multi-process
fleet emits them.  ``SPAN_KINDS`` are the port's own: timed spans inside a
request, kept in a ring of their own (``Recorder.span``), never in the
lifecycle stream or its sink.
"""
from __future__ import annotations

import re

#: v1 = the PR-7 lifecycle kinds; v2 adds the DAG ready-set kinds
#: ``task_held`` / ``task_ready`` (DESIGN.md §11).  load_events hard-errors
#: on sinks written by any other version.
EVENT_SCHEMA_VERSION = 2

# -- lifecycle kinds (per task) ---------------------------------------------
TASK_ARRIVED = "task_arrived"        # Dispatcher.submit
TASK_HELD = "task_held"              # submitted with unmet deps (ready-set)
TASK_READY = "task_ready"            # last dep completed; about to enqueue
TASK_QUEUED = "task_queued"          # entered the wait queue (front=retry/requeue)
TASK_LEASED = "task_leased"          # queue-head slice leased to a host
TASK_CLAIMED = "task_claimed"        # host claim reconciled against the lease pool
TASK_DISPATCHED = "task_dispatched"  # bound to an executor
INPUT = "input"                      # one input resolved: oid, source, bytes
EXEC_START = "exec_start"            # task function begins
EXEC_END = "exec_end"                # task function returned
TASK_DONE = "task_done"
TASK_FAILED = "task_failed"          # terminal failure (attempts exhausted / dep_failed)
TASK_REQUEUED = "task_requeued"      # retry / lease return / executor loss

# -- aggregate kinds --------------------------------------------------------
PUMP = "pump"                        # one dispatch pass: n bound, queue depth
POOL = "pool"                        # executor pool transition: size, delta
PROVISION = "provision"              # DRP decision: allocate, release

LIFECYCLE_KINDS = (
    TASK_ARRIVED, TASK_HELD, TASK_READY, TASK_QUEUED, TASK_LEASED,
    TASK_CLAIMED, TASK_DISPATCHED,
    INPUT, EXEC_START, EXEC_END, TASK_DONE, TASK_FAILED, TASK_REQUEUED,
)
EVENT_KINDS = frozenset(LIFECYCLE_KINDS) | {PUMP, POOL, PROVISION}

# -- span kinds (the port's own; Recorder.span) -----------------------------
# ``store_copy``: a store read's host-to-device copy; ``fn``: the task
# function, wall and thread CPU; ``launch``: a kernel launch call, launch to
# return; ``gc``: one pause of the interpreter's collector.  Each span has a
# start ``t`` and a duration ``dur`` on the recorder's clock; ``parent``
# names what caused it: a span kind, or ``stage``, the staging of a
# request's inputs (dispatch -> exec_start in the lifecycle stream)
SPAN_KINDS = frozenset({"store_copy", "fn", "launch", "gc"})

# Input sources (the ``source`` field of INPUT events).
SOURCE_LOCAL = "local"
SOURCE_PEER = "peer"
SOURCE_STORE = "store"

# Required keys of a measured per-task outcome record (trace v3 rows).
OUTCOME_FIELDS = (
    "tid", "executor", "attempts",
    "queue_s", "exec_s", "turnaround_s",
    "bytes_local", "bytes_peer", "bytes_store",
    "cache_hits", "peer_hits", "cache_misses",
)

_EXEC_RE = re.compile(r"(\d+)$")


def exec_index(eid):
    """Normalize an executor id to its numeric index (sim names nodes
    ``e{i}``, the runtime and fleet name them ``w{i}``; the index is the
    scheduling-determined part)."""
    if eid is None:
        return None
    m = _EXEC_RE.search(str(eid))
    return int(m.group(1)) if m else str(eid)


def outcome_record(task, base=0.0):
    """Measured per-task outcome dict built from a completed Task.

    ``base`` rebases the absolute clock fields (the runtime stamps tasks with
    raw ``time.monotonic()``; the sim already starts at 0).  Latency fields
    are clock-base independent.
    """
    sub = task.submit_time
    dis = task.dispatch_time if task.dispatch_time is not None else sub
    st = task.start_time if task.start_time is not None else dis
    en = task.end_time if task.end_time is not None else st
    return {
        "tid": task.tid,
        "executor": task.executor,
        "attempts": task.attempts,
        "t_submit": sub - base,
        "t_dispatch": dis - base,
        "t_start": st - base,
        "t_end": en - base,
        "queue_s": dis - sub,
        "exec_s": en - st,
        "turnaround_s": en - sub,
        "bytes_local": task.bytes_local,
        "bytes_peer": task.bytes_cache_to_cache,
        "bytes_store": task.bytes_store,
        "cache_hits": task.cache_hits,
        "peer_hits": task.peer_hits,
        "cache_misses": task.cache_misses,
    }


def lifecycle_fingerprints(events):
    """Collapse an event stream into per-task, clock-free fingerprints.

    Returns ``{tid: (kinds, exec_idx, inputs)}`` where ``kinds`` is the tuple
    of lifecycle kinds in emission order, ``exec_idx`` the normalized index
    of the executor that ran the task, and ``inputs`` the sorted tuple of
    ``(oid, source, bytes)`` triples.  Two engines replaying the same trace
    batch-synchronously must produce EQUAL fingerprint maps even though their
    clocks (and the interleaving across tasks) differ.
    """
    kinds: dict = {}
    execs: dict = {}
    inputs: dict = {}
    for e in events:
        tid = e.get("tid")
        if tid is None or e["kind"] not in EVENT_KINDS:
            continue
        k = e["kind"]
        if k == INPUT:
            inputs.setdefault(tid, []).append(
                (e["oid"], e["source"], e["bytes"]))
        else:
            kinds.setdefault(tid, []).append(k)
        if k == EXEC_START:
            execs[tid] = exec_index(e.get("eid"))
    return {
        tid: (
            tuple(ks),
            execs.get(tid),
            tuple(sorted(inputs.get(tid, ()))),
        )
        for tid, ks in kinds.items()
    }
