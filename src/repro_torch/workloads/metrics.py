"""Per-run headline metrics -- the numbers the papers actually report.

Given a finished simulator run (SimResult + the pool log the simulator keeps
for elastic runs), :class:`MetricsCollector` computes:

  cache_hit_ratio       any access served without touching the persistent
                        store (paper Figure 10's metric; local + peer hits).
                        Accounting is *per input*, not per task, so the
                        ratio stays meaningful for k-input joins: a task
                        that hits 2 of its 3 stacked files contributes
                        2 hits + 1 store read, not one blended outcome;
  join split            the per-task view of the same ledger: how many
                        completed tasks had ALL inputs served cache-side
                        (full_hit_tasks), a strict subset (partial_hit_
                        tasks), or none (zero_hit_tasks), plus the mean
                        join width (mean_inputs_per_task);
  read_bandwidth_bps /  aggregate I/O bandwidth: task-input consumption and
  moved_bandwidth_bps   total bytes moved per second of busy span (Fig 3/4);
  efficiency            delivered read bandwidth / the testbed's ideal for
                        the *peak* live pool (Figure 3's "fraction of ideal");
  avg_slowdown          arXiv 0808.3535's per-task metric: turnaround time
                        (completion - arrival) divided by the task's ideal
                        duration on an otherwise-idle executor with a warm
                        cache (compute + overhead + local-disk I/O).  1.0 is
                        perfect; queueing, cold caches and store contention
                        push it up;
  performance_index     0808.3535's resource-normalised score: ideal
                        core-seconds of completed work divided by allocated
                        executor core-seconds (the integral of the live pool
                        over the run).  High PI = the provisioner bought
                        only the resources the demand curve needed.

All inputs come from engine observables; the collector never re-runs
anything, so collecting metrics is free and bit-deterministic: identical
runs (e.g. a trace replayed from JSONL) produce identical RunMetrics.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Optional, Sequence

from repro_torch.core.testbeds import TestbedSpec


@dataclass(frozen=True)
class RunMetrics:
    n_tasks: int
    n_completed: int
    n_failed: int
    makespan_s: float
    busy_span_s: float
    tasks_per_second: float
    # cache economics
    local_hits: int
    peer_hits: int
    store_reads: int
    local_hit_ratio: float
    cache_hit_ratio: float            # global: (local + peer) / all accesses
    # join (multi-input) split, over completed tasks with >= 1 input
    mean_inputs_per_task: float
    full_hit_tasks: int               # every input local/peer-served
    partial_hit_tasks: int            # some inputs cache-side, some store
    zero_hit_tasks: int               # every input read from the store
    # aggregate I/O
    read_bandwidth_bps: float
    moved_bandwidth_bps: float
    efficiency: float                 # delivered read bw / ideal(peak pool)
    # 0808.3535 workload metrics.  avg/p95_slowdown measure from *arrival*
    # (the paper's definition, and what the committed gates canary);
    # slowdown_from_ready measures from the moment the task became runnable
    # (deps met), so dep-wait does not read as scheduler queueing.  Dep-free
    # workloads: slowdown_from_arrival == avg_slowdown == slowdown_from_ready.
    avg_slowdown: float
    p95_slowdown: float
    slowdown_from_arrival: float
    slowdown_from_ready: float
    performance_index: float
    # elasticity
    peak_executors: int
    low_executors: int
    executor_seconds: float

    def as_dict(self) -> dict:
        return asdict(self)


def _ideal_task_seconds(task, sizes: dict[str, int], tb: TestbedSpec) -> float:
    """Best-case duration: warm local cache, idle node, no queueing."""
    in_bytes = sum(sizes.get(oid, 0) for oid in task.inputs)
    out_bytes = sum(ob.size_bytes for ob in task.outputs)
    return (task.compute_seconds + tb.task_overhead_s
            + tb.store_meta_latency_s * task.store_metadata_ops
            + in_bytes / tb.disk_read_bw
            + out_bytes / tb.disk_write_bw)


def _pool_integral(pool_log: Sequence[tuple[float, int]], t_end: float,
                   initial: int = 0) -> tuple[float, int, int]:
    """Integrate live-executor count over [0, t_end] from (t, live) samples.

    Returns (executor_seconds, peak, low). ``low`` is the minimum AFTER the
    first sample (so a run that only ever grows reports its start size).
    """
    if not pool_log:
        return initial * t_end, initial, initial
    secs = 0.0
    prev_t, prev_n = 0.0, initial
    peak = low = pool_log[0][1]
    for t, n in pool_log:
        secs += prev_n * (max(t, prev_t) - prev_t)
        prev_t, prev_n = max(t, prev_t), n
        peak, low = max(peak, n), min(low, n)
    secs += prev_n * max(t_end - prev_t, 0.0)
    return secs, peak, low


class MetricsCollector:
    """Computes RunMetrics from a simulator run.

    ``collect(result)`` takes the SimResult returned by DiffusionSim.run();
    the pool log and testbed ride along inside the result.
    """

    def __init__(self, testbed: TestbedSpec, cpus_per_node: int = 1) -> None:
        self.testbed = testbed
        self.cpus_per_node = cpus_per_node

    def collect(self, result, n_submitted: Optional[int] = None) -> RunMetrics:
        tb = self.testbed
        d = result.dispatcher
        pool_log = getattr(result, "pool_log", [])
        t_end = result.makespan
        exec_secs, peak, low = _pool_integral(pool_log, t_end)
        exec_secs *= self.cpus_per_node

        slowdowns: list[float] = []
        ready_slowdowns: list[float] = []
        ideal_core_s = 0.0
        n_inputs = full_hit = partial_hit = zero_hit = 0
        for t in d.completed:
            ideal = _ideal_task_seconds(t, d.sizes, tb)
            ideal_core_s += ideal
            turnaround = t.end_time - t.submit_time
            slowdowns.append(max(turnaround, 0.0) / max(ideal, 1e-12))
            # ready_time is stamped at submit for dep-free tasks and at
            # release for dep-waiters; 0.0 (a twin / direct Task) falls
            # back to arrival so both bases agree exactly when dep-free
            ready = t.ready_time if t.ready_time else t.submit_time
            ready_slowdowns.append(
                max(t.end_time - ready, 0.0) / max(ideal, 1e-12))
            n_inputs += len(t.inputs)
            if t.inputs:
                # cache-side inputs = local hits + peer fetches; the rest
                # touched the store (cache_misses counts peer AND store)
                cached = t.cache_hits + t.peer_hits
                if t.cache_misses == t.peer_hits:
                    full_hit += 1
                elif cached == 0:
                    zero_hit += 1
                else:
                    partial_hit += 1
        # both bases sum over SORTED samples: float addition is order-
        # sensitive, and dep-free runs must yield bit-equal values
        slowdowns.sort()
        ready_slowdowns.sort()
        avg_sd = sum(slowdowns) / len(slowdowns) if slowdowns else 0.0
        p95_sd = slowdowns[min(int(0.95 * len(slowdowns)),
                               len(slowdowns) - 1)] if slowdowns else 0.0

        read_bw = result.read_throughput()
        ideal_bw = tb.ideal_read_bw(max(peak, 1))
        accesses = result.local_hits + result.peer_hits + result.store_reads
        return RunMetrics(
            n_tasks=n_submitted if n_submitted is not None else len(d.tasks),
            n_completed=result.n_completed,
            n_failed=result.n_failed,
            makespan_s=result.makespan,
            busy_span_s=result.busy_span,
            tasks_per_second=result.tasks_per_second(),
            local_hits=result.local_hits,
            peer_hits=result.peer_hits,
            store_reads=result.store_reads,
            local_hit_ratio=result.local_hit_ratio if accesses else 0.0,
            cache_hit_ratio=result.global_hit_ratio if accesses else 0.0,
            mean_inputs_per_task=(n_inputs / len(d.completed)
                                  if d.completed else 0.0),
            full_hit_tasks=full_hit,
            partial_hit_tasks=partial_hit,
            zero_hit_tasks=zero_hit,
            read_bandwidth_bps=read_bw,
            moved_bandwidth_bps=result.moved_throughput(),
            efficiency=read_bw / ideal_bw if ideal_bw > 0 else 0.0,
            avg_slowdown=avg_sd,
            p95_slowdown=p95_sd,
            slowdown_from_arrival=avg_sd,
            slowdown_from_ready=(sum(ready_slowdowns) / len(ready_slowdowns)
                                 if ready_slowdowns else 0.0),
            performance_index=(ideal_core_s / exec_secs
                               if exec_secs > 0 else 0.0),
            peak_executors=peak,
            low_executors=low,
            executor_seconds=exec_secs,
        )
