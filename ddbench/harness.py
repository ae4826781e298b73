"""One run of one cell: set-up, the measured window, the comparison.

The program is driven through its experiment API,
``repro_torch.experiments.RuntimeEngine``: ``prepare(spec, workload)``, then
either the runtime's ``submit`` of the whole trace when the window opens (a
closed loop) or the engine's ``run``, which provisions the pool and paces
an open loop through the runtime's ``submit_workload``.

What the benchmark takes itself, on the host's monotonic clock: the
window's ends and when each request was due (its schedule).  What it reads
from the program once the window and its requests are over: when each
request completed (``Task.end_time``, the dispatcher's monotonic stamp),
which failed, each request's ledger and timestamps, the runtime's pool log,
the dispatch lock's held time, and, in a traced run, the recorder's exec
spans and the card's activity.  Nothing of the benchmark runs inside the
window but the sleep of its main thread (and, traced, the profiler).
"""
from __future__ import annotations

import gc
import importlib
import math
import subprocess
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.core import DataObject, Task
from repro_torch.experiments import (CacheSpec, ClusterSpec, ExperimentSpec,
                                     ObserveSpec, ProvisionerSpec,
                                     RuntimeEngine, WorkloadSpec)
from repro_torch.workloads.workload import TaskEvent, Workload

from . import devtrace, traffic

#: how long past the close a request due in the window is waited for (s)
GRACE_S = 60.0
#: warm-up and drain waits (s)
WARMUP_TIMEOUT_S = 120.0
#: recorder ring for a traced run: about 8 events a request, none dropped
RING = 1 << 22


@dataclass
class Run:
    """What one run saw; the metric readers and the checks read this."""

    cell: str
    cfg: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    loop: str
    setup_s: float
    t_open: float
    t_close: float
    #: tid -> due time (monotonic): the requests the window is answerable
    #: for (closed loop: dispatched before the close; open: due before it)
    due: dict
    #: tid -> when it completed (``Task.end_time``) / the first look that
    #: found it failed (monotonic)
    done_at: dict
    failed_at: dict
    #: tid -> the program's per-request ledger and timestamps
    ledger: dict
    #: tid -> (file oids, output) of every completed request in ``due``
    outputs: dict
    lock_hold_s: float
    #: (seconds after the open, live executors) at each change
    pool: list
    spans: Optional[dict] = None
    device: Optional[devtrace.DeviceTrace] = None
    memory_peak_bytes: int = 0
    extra: dict = field(default_factory=dict)

    @property
    def window(self) -> list[str]:
        """The window's requests: completed in it (closed loop), or due in
        it (open loop)."""
        if self.loop == "closed":
            return [tid for tid, t in self.done_at.items()
                    if tid in self.ledger and self.t_open <= t <= self.t_close]
        return list(self.due)

    @property
    def drain_s(self) -> float:
        """From the open to the last completion of a due request."""
        ends = [self.done_at[t] for t in self.due if t in self.done_at]
        return (max(ends) if ends else self.t_close) - self.t_open


def _task_fn(cfg: dict):
    module, attr = cfg["task_fn"].split(":")
    return getattr(importlib.import_module(module), attr)


def _spec(cfg: dict, mix: dict, n_requests: int, n_files: int,
          trace: bool) -> ExperimentSpec:
    prov = cfg.get("provisioner")
    return ExperimentSpec(
        name=cfg["name"],
        cluster=ClusterSpec(testbed="anl_uc", n_nodes=cfg["executors"]),
        cache=CacheSpec(capacity_bytes=cfg["cache_bytes"],
                        eviction=cfg["eviction"]),
        policy=cfg["policy"],
        provisioner=ProvisionerSpec(**prov) if prov else None,
        # the engine runs the workload handed to prepare(); this binding
        # only describes it (Table 2's stacking trace over the catalog)
        workload=WorkloadSpec(
            name=cfg["name"],
            arrivals={"kind": "PoissonArrivals", "rate_per_s": 1.0},
            popularity={"kind": "StackingTrace",
                        "locality": int(mix["locality"]), "shuffle_seed": 0,
                        "k": 1, "corr": 1.0},
            n_tasks=max(n_requests, 1), n_objects=max(n_files, 1),
            object_bytes=cfg["file_bytes"], object_prefix=cfg["object_prefix"],
            compute_seconds=cfg["host_s_per_request"]),
        observe=ObserveSpec(events=True, ring_capacity=RING) if trace
        else ObserveSpec())


def _oid(cfg: dict, fid: int) -> str:
    return f"{cfg['object_prefix']}{int(fid)}"


def _workload(cfg: dict, plan: traffic.Plan) -> Workload:
    oids = [_oid(cfg, f) for f in plan.files]
    objects = [DataObject(o, cfg["file_bytes"]) for o in sorted(set(oids))]
    events = [TaskEvent(t=float(t), tid=f"req-{i}", inputs=(o,),
                        compute_seconds=cfg["host_s_per_request"])
              for i, (t, o) in enumerate(zip(plan.due, oids))]
    return Workload(cfg["name"], objects, events)


def _join_threads(before: set, timeout_s: float = 30.0) -> list[str]:
    """Join every thread started since ``before`` was taken; the names of
    any still alive."""
    deadline = time.monotonic() + timeout_s
    mine = [th for th in threading.enumerate() if th not in before]
    for th in mine:
        th.join(max(deadline - time.monotonic(), 0.0))
    return [th.name for th in mine if th.is_alive()]


def resolve(device: str | torch.device) -> torch.device:
    """``device`` with its index: the device tensors made there report."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def card_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


def run_cell(cell: str, cfg: dict, mix: dict, ref, seed: int, seconds: float,
             trace: bool, t_proc0: float, device: str = "cuda",
             task_fn=None) -> Run:
    """Set up, measure ``seconds``, wait for the window's requests, free the
    program's state.  ``task_fn`` replaces the configuration's (the control
    and the fault tests put theirs in the program's place)."""
    dev = resolve(device)
    cuda = dev.type == "cuda"
    threads_before = set(threading.enumerate())
    fn = task_fn if task_fn is not None else _task_fn(cfg)
    plan = traffic.plan(mix, seed, seconds)
    wl = _workload(cfg, plan)
    catalog = ref.make_catalog(cfg, plan.n_files, seed, dev)
    eng = RuntimeEngine(device=dev).prepare(
        _spec(cfg, mix, len(plan), plan.n_files, trace), workload=wl)
    rt = eng.runtime
    for fid in range(plan.n_files):
        rt.put_object(DataObject(_oid(cfg, fid), cfg["file_bytes"]),
                      catalog[fid])
    warm = [Task(inputs=(_oid(cfg, f),), fn=fn, tid=f"warm-{j}")
            for j, f in enumerate(plan.warmup_files)]
    rt.submit(warm)
    if not rt.wait(WARMUP_TIMEOUT_S):
        raise RuntimeError("warm-up requests did not complete")
    if any(t.tid.startswith("warm-") for t in rt.dispatcher.failed):
        raise RuntimeError("a warm-up request failed")
    if cuda:
        torch.cuda.synchronize(dev)
        if trace:
            devtrace.warm_up(dev)
    rec = eng.recorder
    requests = None
    if plan.loop == "closed":
        requests = [t for _, t in wl.tasks()]
        for t in requests:
            t.fn = fn
    span = devtrace.Span(dev) if trace and cuda else None
    runner = None
    if span is not None:
        span.__enter__()
    lock0 = rt.stats.lock_hold_s
    t_open = time.monotonic()
    rec_offset = t_open - rec.clock() if rec is not None else 0.0
    if requests is not None:
        rt.submit(requests)
    else:
        runner = _Runner(eng, fn, seconds + GRACE_S)
        runner.start()
    t_close = t_open + seconds
    time.sleep(max(t_close - time.monotonic(), 0.0))
    lock1 = rt.stats.lock_hold_s
    if span is not None:
        span.__exit__(None, None, None)
    setup_s = t_open - t_proc0

    tasks = rt.dispatcher.tasks
    if plan.loop == "closed":
        due = {tid: t_open for tid, t in list(tasks.items())
               if tid.startswith("req-") and 0.0 < t.dispatch_time <= t_close}
    else:
        due = {f"req-{i}": t_open + float(t) for i, t in enumerate(plan.due)}
    deadline = t_close + GRACE_S
    ended = _Ended(rt.dispatcher)
    pending = set(due)
    while pending and time.monotonic() < deadline:
        ended.look()
        pending = {tid for tid in pending if tid not in ended.done_at
                   and tid not in ended.failed_at}
        time.sleep(0.01)
    if runner is not None:
        runner.join(max(deadline - time.monotonic(), 0.0) + 5.0)
    ended.look()
    if cuda:
        torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    ledger, outputs, failures = {}, {}, []
    for tid in due:
        t = tasks.get(tid)
        if t is None:
            continue
        ledger[tid] = {
            "inputs": t.inputs,
            "input_bytes": len(t.inputs) * cfg["file_bytes"],
            "bytes_local": t.bytes_local,
            "bytes_c2c": t.bytes_cache_to_cache,
            "bytes_store": t.bytes_store,
            "cache_hits": t.cache_hits, "peer_hits": t.peer_hits,
            "cache_misses": t.cache_misses,
            "submit_time": t.submit_time, "dispatch_time": t.dispatch_time,
            "start_time": t.start_time, "end_time": t.end_time}
        if tid in ended.done_at:
            outputs[tid] = (t.inputs, t.result)
        elif tid in ended.failed_at and len(failures) < 8:
            failures.append(f"{tid}: {t.attempts} attempts, last "
                            f"{t.result!r:.120}")
    spans = None
    if rec is not None:
        starts, ends = {}, {}
        for e in rec.events():
            if e["kind"] == "exec_start":
                starts[e["tid"]] = e["t"] + rec_offset
            elif e["kind"] == "exec_end":
                ends[e["tid"]] = e["t"] + rec_offset
        spans = {tid: (starts[tid], ends[tid]) for tid in ledger
                 if tid in starts and tid in ends}
    # the runtime logs (seconds since it was built, live executors) at each
    # change of its pool, as the engine's RunReport reads it
    log = [(rt._t0 + t, n) for t, n in list(rt.pool_log)]
    pool = [(0.0, [n for t, n in log if t <= t_open][-1])]
    pool += [(t - t_open, n) for t, n in log if t > t_open]
    extra = {"provision_failures": eng.provision_failures,
             "grace_s": GRACE_S, "failed_requests": failures}
    if runner is not None and runner.error is not None:
        extra["run_error"] = f"{type(runner.error).__name__}: {runner.error}"

    # the program's state goes before the reference runs
    eng.shutdown()
    extra["threads_left"] = _join_threads(threads_before)
    del eng, rt, tasks, wl, catalog, warm, requests
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return Run(cell=cell, cfg=cfg, mix=mix, seed=seed, seconds=seconds,
               trace=trace, loop=plan.loop, setup_s=setup_s, t_open=t_open,
               t_close=t_close, due=due,
               done_at=_trace_only(ended.done_at),
               failed_at=_trace_only(ended.failed_at), ledger=ledger,
               outputs=outputs,
               lock_hold_s=lock1 - lock0, pool=pool, spans=spans,
               device=span.trace if span is not None else None,
               memory_peak_bytes=peak, extra=extra)


class _Ended:
    """What the dispatcher lists as completed (stamped with the program's
    ``Task.end_time``) or failed (stamped when first found), read on the
    caller's thread after the window."""

    def __init__(self, dispatcher) -> None:
        self.dispatcher = dispatcher
        self.done_at: dict[str, float] = {}
        self.failed_at: dict[str, float] = {}
        self._seen = [0, 0]

    def look(self) -> None:
        now = time.monotonic()
        d = self.dispatcher
        for i, src in enumerate((d.completed, d.failed)):
            new = src[self._seen[i]:]
            self._seen[i] += len(new)
            for t in new:
                if i == 0:
                    self.done_at.setdefault(t.tid, t.end_time)
                else:
                    self.failed_at.setdefault(t.tid, now)


def _trace_only(stamps: dict) -> dict:
    """The stamps of the trace's requests (not the warm-up's)."""
    return {tid: t for tid, t in stamps.items() if tid.startswith("req-")}


class _Runner(threading.Thread):
    """``eng.run`` of an open loop, on its own thread: it starts the
    provisioner, paces the arrivals and waits for them to drain."""

    def __init__(self, eng, fn, timeout_s: float) -> None:
        super().__init__(daemon=True, name="bench-open-loop")
        self.eng, self.fn, self.timeout_s = eng, fn, timeout_s
        self.error: Optional[BaseException] = None

    def run(self) -> None:
        try:
            self.eng.run(task_fn=self.fn, time_scale=1.0,
                         timeout=self.timeout_s)
        except Exception as e:  # noqa: BLE001 - reported with the run
            self.error = e


def checks(run: Run, ref, device: torch.device) -> dict:
    """Each number compared, with its limit (from the configuration)."""
    limits = run.cfg["limits"]
    unresolved = sum(1 for tid in run.due
                     if tid not in run.done_at and tid not in run.failed_at)
    mismatch = 0
    size = run.cfg["file_bytes"]
    for tid, lg in run.ledger.items():
        if tid not in run.done_at:
            continue
        split = lg["bytes_local"] + lg["bytes_c2c"] + lg["bytes_store"]
        n_in = len(lg["inputs"])
        if (split != lg["input_bytes"]
                or lg["cache_hits"] + lg["cache_misses"] != n_in
                or not 0 <= lg["peer_hits"] <= lg["cache_misses"]
                or lg["bytes_local"] != lg["cache_hits"] * size
                or lg["bytes_c2c"] != lg["peer_hits"] * size):
            mismatch += 1
    lo, hi = run.cfg["pool_min"], run.cfg["pool_max"]
    out_of_bounds = sum(1 for _, n in run.pool if not lo <= n <= hi)
    requests = [run.outputs[tid] for tid in run.due if tid in run.outputs]
    err = ref.worst_error(run.cfg, run.seed, requests, device)
    values = {
        "coadd_rel_err": err,
        "unresolved": unresolved,
        "failed": sum(1 for tid in run.due if tid in run.failed_at),
        "ledger_mismatch": mismatch,
        "pool_out_of_bounds": out_of_bounds,
    }
    return {k: {"value": v, "limit": limits[k]} for k, v in values.items()}


def passed(check: dict) -> bool:
    return all(not math.isnan(c["value"]) and c["value"] <= c["limit"]
               for c in check.values())
