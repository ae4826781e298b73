"""Engine adapter: one `ExperimentSpec` -> the threaded runtime -> one `RunReport`.

Counterpart of the reference's in-process ``RuntimeEngine``: ``prepare(spec)``
builds a :class:`DiffusionRuntime` on ``device`` and binds the workload,
``run()`` executes and returns a :class:`RunReport`.  Observables funnel
through ``MetricsCollector`` via a `SimResult`-shaped view, so every
reported number is computed by the reference's formula (report.py).

Spec knobs the runtime cannot honour hard-error instead of being ignored.
One deliberate translation: ``cache.enabled=False`` (the paper's
data-unaware baseline) maps to zero-capacity caches -- nothing is ever
admitted, so hit/byte accounting matches "no caches".
"""
from __future__ import annotations

import importlib
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.core.cache import EvictionPolicy
from repro_torch.core.objects import DataObject
from repro_torch.core.policies import DispatchPolicy
from repro_torch.core.runtime import SHAPE_ONLY_PAYLOAD, DiffusionRuntime
from repro_torch.core.simulator import SimResult
from repro_torch.core.testbeds import TESTBEDS
from repro_torch.workloads import (ARRIVALS, POPULARITY, MetricsCollector,
                                   Workload, build_dag, generate)

from .report import RunReport, build_report
from .spec import ExperimentSpec, WorkloadSpec


def build_workload(wspec: WorkloadSpec) -> Workload:
    """Materialise the workload a spec binds: the DAG recipe, or the
    generator recipe (bit-identical to calling ``workloads.generate`` with
    the same arguments -- the binding dicts ARE constructor kwargs)."""
    if wspec.dag is not None:
        return build_dag(wspec.dag, name=wspec.name)
    arr = ARRIVALS[wspec.arrivals["kind"]](
        **{k: v for k, v in wspec.arrivals.items() if k != "kind"})
    pop = POPULARITY[wspec.popularity["kind"]](
        **{k: v for k, v in wspec.popularity.items() if k != "kind"})
    objects = None
    if wspec.object_prefix is not None:
        objects = [DataObject(f"{wspec.object_prefix}{i}", wspec.object_bytes)
                   for i in range(wspec.n_objects)]
    return generate(
        wspec.name, arr, pop, n_tasks=wspec.n_tasks,
        objects=objects, n_objects=wspec.n_objects,
        object_bytes=wspec.object_bytes,
        compute_seconds=wspec.compute_seconds,
        output_bytes=wspec.output_bytes,
        store_metadata_ops=wspec.store_metadata_ops,
        seed=wspec.seed)


def resolve_task_fn(name: str) -> Callable[..., Any]:
    """A task callable named ``module:attr`` (e.g.
    ``repro_torch.apps.astro:stack_object``)."""
    module, sep, attr = name.partition(":")
    if not sep or not module or not attr:
        raise ValueError(f"task fn name {name!r} is not 'module:attr'")
    return getattr(importlib.import_module(module), attr)


class RuntimeEngine:
    """Threaded-runtime adapter.  ``run()`` paces the workload in (see
    `DiffusionRuntime.submit_workload`), drains it, and reports in wall
    seconds.  ``self.runtime`` stays alive afterwards for payload/result
    inspection; call :meth:`shutdown` when done.

    ``device`` defaults to ``"cuda"`` (the executors' caches and every task
    input live there); pass ``device="cpu"`` to run on the CPU.
    ``task_fn_name`` names the task callable as ``module:attr`` instead of
    passing ``run(task_fn=...)``."""

    name = "runtime"

    def __init__(self, task_fn_name: Optional[str] = None,
                 device: str | torch.device = "cuda") -> None:
        self.spec: Optional[ExperimentSpec] = None
        self.runtime: Optional[DiffusionRuntime] = None
        self.workload: Optional[Workload] = None
        self.task_fn_name = task_fn_name
        self.device = device
        self.result = None
        self.metrics = None

    def prepare(self, spec: ExperimentSpec,
                workload: Optional[Workload] = None) -> "RuntimeEngine":
        if spec.cluster.cpus_per_node != 1:
            raise ValueError(
                f"spec sets cluster.cpus_per_node={spec.cluster.cpus_per_node}"
                f", which the runtime engine does not support (workers are "
                f"1-slot).  Refusing to run rather than silently ignoring it.")
        self.spec = spec
        self.runtime = DiffusionRuntime(
            n_executors=spec.cluster.n_nodes,
            policy=DispatchPolicy(spec.policy),
            cache_policy=EvictionPolicy(spec.cache.eviction),
            cache_capacity_bytes=(spec.cache.capacity_bytes
                                  if spec.cache.enabled else 0),
            seed=spec.seed,
            index_update_batch=spec.index_update_batch,
            device=self.device)
        self.workload = workload if workload is not None \
            else build_workload(spec.workload)
        return self

    def run(self, *,
            task_fn: Optional[Callable[..., Any]] = None,
            payload_factory: Optional[Callable[[DataObject], Any]] = None,
            time_scale: float = 0.0,
            timeout: float = 600.0,
            barrier_every: Optional[int] = None) -> RunReport:
        rt = self.runtime
        if rt is None:
            raise RuntimeError("call prepare(spec) before run()")
        if task_fn is None and self.task_fn_name:
            task_fn = resolve_task_fn(self.task_fn_name)
        if payload_factory is None:
            # shape-only runs (no task_fn) still need store payloads to
            # resolve; byte accounting uses DataObject sizes, not payloads
            payload_factory = lambda ob: SHAPE_ONLY_PAYLOAD  # noqa: E731
        t0 = time.monotonic()
        submitter = rt.submit_workload(
            self.workload, task_fn=task_fn,
            payload_factory=payload_factory, time_scale=time_scale,
            barrier_every=barrier_every)
        submitter.join(timeout)
        drained = (not submitter.is_alive()
                   and rt.wait(max(timeout - (time.monotonic() - t0), 0.01)))
        if not drained:
            rt.shutdown()
            raise TimeoutError(
                f"runtime run of {self.spec.name!r} did not drain within "
                f"{timeout}s ({len(rt.dispatcher.completed)} completed)")
        wall = time.monotonic() - t0
        r = self._result_view(t_run0=t0, t_end=time.monotonic())
        tb = TESTBEDS[self.spec.cluster.testbed]
        m = MetricsCollector(tb, cpus_per_node=1).collect(
            r, n_submitted=len(self.workload))
        self.result, self.metrics = r, m
        return build_report(self.spec, self.name, r, m, wall_s=wall,
                            dispatch_stats=rt.dispatch_stats())

    def _result_view(self, t_run0: float, t_end: float) -> SimResult:
        """The runtime's observables in `SimResult` shape, with every clock
        rebased to seconds since ``run()`` started (NOT since runtime
        construction -- the prepare->run gap, e.g. workload generation,
        must not inflate makespan or the pool integral)."""
        rt = self.runtime
        offset = t_run0 - rt._t0   # pool_log times are construction-relative
        d = rt.dispatcher
        lg = rt.ledger
        starts = [t.start_time for t in d.completed]
        ends = [t.end_time for t in d.completed]
        return SimResult(
            makespan=t_end - t_run0,
            t_first_dispatch=(min(starts) - t_run0) if starts else 0.0,
            t_last_complete=(max(ends) - t_run0) if ends else 0.0,
            bytes_by_kind={"local": float(lg.bytes_local),
                           "c2c": float(lg.bytes_c2c),
                           "store_read": float(lg.bytes_store)},
            n_completed=len(d.completed),
            n_failed=len(d.failed),
            local_hits=lg.local_hits,
            peer_hits=lg.peer_hits,
            store_reads=lg.store_reads,
            dispatcher=d,
            flow_log=[],
            pool_log=[(max(t - offset, 0.0), n) for t, n in rt.pool_log],
        )

    def shutdown(self) -> None:
        if self.runtime is not None:
            self.runtime.shutdown()
