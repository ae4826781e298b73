"""Versioned JSONL trace format: record a Workload, replay it bit-identically.

Format (one JSON object per line):

  {"kind": "header", "version": 2, "name": ..., "n_objects": ...,
   "n_tasks": ..., "spec": {...}}                       # line 1, required
  {"kind": "object", "oid": ..., "size": ...}           # catalog entries
  {"kind": "task", "t": ..., "tid": ..., "inputs": [[oid, size], ...],
   "outputs": [[oid, size], ...], "compute_s": ..., "meta_ops": ...}

Version history:

  v1  single-input era: ``"inputs": [oid, ...]`` (sizes live only in the
      catalog).  Still read bit-identically -- a v1 trace replays to the
      same TaskEvents (and therefore the same RunMetrics) it always did;
      tests/data/trace_v1.jsonl is the committed regression fixture.
  v2  multi-input (join) era: each input is an ``[oid, size]`` pair, so a
      task line is self-describing (k-input byte totals without a catalog
      join) and size drift between the task lines and the catalog is a
      hard error instead of silent disagreement.
  v3  measured-outcome era (written by :func:`record_v3` only; plain
      :func:`record` still writes v2 -- arrivals-only traces gain nothing
      from the bump).  A v3 trace is a v2 trace plus, after the task rows,
      one ``{"kind": "outcome", ...}`` row per *measured* task completion
      (executor, attempts, per-source byte split, queue/exec/turnaround
      latencies -- the `repro_torch.obs.events.outcome_record` schema), and
      its header carries ``n_outcomes`` so truncation stays a hard error.
      :func:`replay` reads the arrival half of a v3 trace bit-identically
      to v2 (outcome rows don't exist to it beyond the count check);
      :func:`read_outcomes` reads the measured half.  One file therefore
      carries both what a run was ASKED to do and what a real fleet
      MEASURED doing it -- the sim twin replays the former,
      repro_torch.obs.diff joins the latter against the sim's prediction per
      task.
  v4  DAG era: task rows gain ``"deps": [tid, ...]`` (producer tasks that
      must complete first) and input pairs may name *produced* oids, whose
      sizes come from the producing row's outputs rather than the catalog.
      Written only when the workload actually carries dep edges --
      :func:`record` / :func:`record_v3` keep emitting byte-identical
      v2 / v3 for dep-free workloads, so every committed v1-v3 fixture and
      parity surface replays unchanged.  A v4 header always carries
      ``n_outcomes`` (0 when recorded without a measured half) and v4 may
      carry outcome rows exactly as v3 does.

Round-trip guarantee: ``replay(record(wl))`` reproduces the *exact* event
sequence -- same tids, arrival times, input/output sets and sizes -- because
Python's json emits shortest-round-trip float reprs and the reader rebuilds
the same frozen TaskEvents.  Running the replayed workload through a
deterministic engine therefore yields bit-identical metrics (enforced by
tests/test_workload_trace.py).

The version field gates schema evolution: readers *hard-error* on versions
they do not understand (anything outside SUPPORTED_VERSIONS) instead of
best-effort parsing -- a half-understood trace silently skews every metric
downstream of it.

A copy of the reference's ``repro.workloads.trace``: either package reads
the other's traces, v1-v4, to the same workload (tests/test_torch_trace.py).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import IO, Union

from repro_torch.core.objects import DataObject

from .workload import TaskEvent, Workload

#: version written by :func:`record` for dep-free workloads
TRACE_VERSION = 2
#: version written by :func:`record_v3` (arrivals + measured outcomes)
TRACE_VERSION_V3 = 3
#: version written when the workload carries dependency edges
TRACE_VERSION_V4 = 4
#: versions :func:`replay` understands (v1 = single-input era traces)
SUPPORTED_VERSIONS = (1, 2, 3, 4)


def _open(path_or_file: Union[str, Path, IO[str]], mode: str):
    if hasattr(path_or_file, "write") or hasattr(path_or_file, "read"):
        return path_or_file, False
    return open(path_or_file, mode), True


def _trace_sizes(wl: Workload) -> dict[str, int]:
    """oid -> size for everything a task row may reference: the catalog
    plus every produced output (v4 inputs may name produced oids)."""
    sizes = {ob.oid: ob.size_bytes for ob in wl.objects}
    for e in wl.events:
        for oid, sz in e.outputs:
            sizes[oid] = sz
    return sizes


def _task_row(e: TaskEvent, sizes: dict[str, int], version: int) -> dict:
    row = {
        "kind": "task", "t": e.t, "tid": e.tid,
        "inputs": [[oid, sizes[oid]] for oid in e.inputs],
        "outputs": [[oid, sz] for oid, sz in e.outputs],
        "compute_s": e.compute_seconds,
        "meta_ops": e.store_metadata_ops,
    }
    if version >= TRACE_VERSION_V4:
        row["deps"] = list(e.deps)
    return row


def record(wl: Workload, path_or_file: Union[str, Path, IO[str]]) -> int:
    """Write ``wl`` as JSONL (schema v2, or v4 when ``wl`` carries dep
    edges); returns the task events written."""
    version = TRACE_VERSION_V4 if wl.has_deps() else TRACE_VERSION
    sizes = _trace_sizes(wl)
    f, should_close = _open(path_or_file, "w")
    try:
        header = {
            "kind": "header", "version": version, "name": wl.name,
            "n_objects": len(wl.objects), "n_tasks": len(wl.events),
            "spec": wl.spec,
        }
        if version >= TRACE_VERSION_V4:
            header["n_outcomes"] = 0
        f.write(json.dumps(header, sort_keys=True) + "\n")
        for ob in wl.objects:
            f.write(json.dumps({"kind": "object", "oid": ob.oid,
                                "size": ob.size_bytes}, sort_keys=True) + "\n")
        for e in wl.events:
            f.write(json.dumps(_task_row(e, sizes, version),
                               sort_keys=True) + "\n")
    finally:
        if should_close:
            f.close()
    return len(wl.events)


def record_v3(wl: Workload, path_or_file: Union[str, Path, IO[str]],
              outcomes: list[dict]) -> int:
    """Write ``wl`` plus measured per-task ``outcomes`` as JSONL (schema
    v3, or v4 when ``wl`` carries dep edges).  Every outcome must carry
    at least the
    `repro_torch.obs.events.OUTCOME_FIELDS` keys (extra keys -- e.g. raw
    timestamps -- are preserved); a missing key hard-errors before the
    first byte is written.  Returns the task events written."""
    from repro_torch.obs.events import OUTCOME_FIELDS

    for i, rec in enumerate(outcomes):
        missing = [k for k in OUTCOME_FIELDS if k not in rec]
        if missing:
            raise ValueError(f"outcome {i} (tid={rec.get('tid')!r}) is "
                             f"missing field(s) {missing}")
    version = TRACE_VERSION_V4 if wl.has_deps() else TRACE_VERSION_V3
    sizes = _trace_sizes(wl)
    f, should_close = _open(path_or_file, "w")
    try:
        f.write(json.dumps({
            "kind": "header", "version": version, "name": wl.name,
            "n_objects": len(wl.objects), "n_tasks": len(wl.events),
            "n_outcomes": len(outcomes), "spec": wl.spec,
        }, sort_keys=True) + "\n")
        for ob in wl.objects:
            f.write(json.dumps({"kind": "object", "oid": ob.oid,
                                "size": ob.size_bytes}, sort_keys=True) + "\n")
        for e in wl.events:
            f.write(json.dumps(_task_row(e, sizes, version),
                               sort_keys=True) + "\n")
        for rec in outcomes:
            f.write(json.dumps({"kind": "outcome", **rec},
                               sort_keys=True) + "\n")
    finally:
        if should_close:
            f.close()
    return len(wl.events)


def read_outcomes(path_or_file: Union[str, Path, IO[str]]) -> list[dict]:
    """Read the measured-outcome rows of a v3/v4 trace.  Hard-errors on
    any other version (a v1/v2 trace HAS no measured half -- silently
    returning [] would read as 'the run completed nothing')."""
    f, should_close = _open(path_or_file, "r")
    try:
        lines = (ln for ln in f if ln.strip())
        try:
            header = json.loads(next(lines))
        except StopIteration:
            raise ValueError("empty trace file") from None
        if header.get("kind") != "header":
            raise ValueError("trace must start with a header line")
        if header.get("version") not in (TRACE_VERSION_V3, TRACE_VERSION_V4):
            raise ValueError(
                f"trace version {header.get('version')!r} carries no "
                f"measured outcomes (need v{TRACE_VERSION_V3}+)")
        out = []
        for ln in lines:
            rec = json.loads(ln)
            if rec.get("kind") == "outcome":
                rec.pop("kind")
                out.append(rec)
    finally:
        if should_close:
            f.close()
    if len(out) != header.get("n_outcomes"):
        raise ValueError(
            f"truncated trace: header promises {header.get('n_outcomes')} "
            f"outcomes, found {len(out)}")
    return out


def _parse_inputs(rec: dict, version: int, sizes: dict[str, int]) -> tuple[str, ...]:
    if version == 1:
        return tuple(rec["inputs"])
    inputs = []
    for oid, sz in rec["inputs"]:
        known = sizes.get(oid)
        if known is not None and known != sz:
            raise ValueError(
                f"task {rec.get('tid')!r} input {oid!r} size {sz} "
                f"disagrees with catalog size {known}")
        inputs.append(oid)
    return tuple(inputs)


def replay(path_or_file: Union[str, Path, IO[str]]) -> Workload:
    """Read a JSONL trace back into a Workload (event-identical)."""
    f, should_close = _open(path_or_file, "r")
    try:
        lines = (ln for ln in f if ln.strip())
        try:
            header = json.loads(next(lines))
        except StopIteration:
            raise ValueError("empty trace file") from None
        if header.get("kind") != "header":
            raise ValueError("trace must start with a header line")
        version = header.get("version")
        if version not in SUPPORTED_VERSIONS:
            raise ValueError(
                f"unsupported trace version {version!r} "
                f"(this reader understands {SUPPORTED_VERSIONS})")
        objects: list[DataObject] = []
        sizes: dict[str, int] = {}
        events: list[TaskEvent] = []
        n_outcomes = 0
        for ln in lines:
            rec = json.loads(ln)
            kind = rec.get("kind")
            if kind == "object":
                objects.append(DataObject(rec["oid"], rec["size"]))
                sizes[rec["oid"]] = rec["size"]
            elif kind == "task":
                events.append(TaskEvent(
                    t=rec["t"], tid=rec["tid"],
                    inputs=_parse_inputs(rec, version, sizes),
                    outputs=tuple((oid, sz) for oid, sz in rec["outputs"]),
                    compute_seconds=rec["compute_s"],
                    store_metadata_ops=rec["meta_ops"],
                    deps=tuple(rec.get("deps", ()))
                    if version >= TRACE_VERSION_V4 else (),
                ))
                for oid, sz in rec["outputs"]:
                    sizes.setdefault(oid, sz)
            elif kind == "outcome" and version >= 3:
                # measured half of a v3 trace: not this reader's business
                # (read_outcomes consumes it), but still truncation-checked
                n_outcomes += 1
            else:
                raise ValueError(f"unknown trace record kind {kind!r}")
    finally:
        if should_close:
            f.close()
    if len(objects) != header.get("n_objects") \
            or len(events) != header.get("n_tasks"):
        raise ValueError(
            f"truncated trace: header promises {header.get('n_objects')} "
            f"objects / {header.get('n_tasks')} tasks, "
            f"found {len(objects)} / {len(events)}")
    if version >= 3 and n_outcomes != header.get("n_outcomes"):
        raise ValueError(
            f"truncated trace: header promises {header.get('n_outcomes')} "
            f"outcomes, found {n_outcomes}")
    return Workload(header.get("name", "trace"), objects, events,
                    spec=header.get("spec"))


def events_fingerprint(wl: Workload) -> tuple:
    """Hashable identity of a workload's full event sequence (for tests)."""
    return (wl.name, tuple(wl.objects),
            tuple((e.t, e.tid, e.inputs, e.outputs, e.compute_seconds,
                   e.store_metadata_ops, e.deps) for e in wl.events))
