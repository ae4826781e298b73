"""Engine adapters: one `ExperimentSpec` -> either engine -> one `RunReport`.

  SimEngine      discrete-event `DiffusionSim` (simulated clock)
  RuntimeEngine  threaded `DiffusionRuntime` (wall clock, real payloads),
                 its executor caches on ``device`` (default ``"cuda"``)

Counterpart of ``repro.experiments.engines`` for those two engines.  Both
follow the same protocol -- ``prepare(spec)`` builds the engine and binds
the workload, ``run()`` executes and returns a :class:`RunReport` -- and
both funnel their observables through ``MetricsCollector`` via a
`SimResult`-shaped view, so every reported number is computed by one
formula regardless of engine (report.py).  A `SimEngine` builds exactly the
`SimConfig` (and `DynamicResourceProvisioner`) the reference's does, so its
reports equal the reference's.

Engine-specific knobs hard-error on the other engine (never silently
ignored): a spec with ``flow_solver="naive"`` refuses to run on the
runtime, and ``index_update_batch=4`` refuses to run on the simulator; the
mapping table is ``spec.ALIASES``.  One deliberate translation:
``cache.enabled=False`` (the paper's data-unaware baseline) maps to
zero-capacity caches on the runtime, which has no ``caching_enabled`` knob
-- nothing is ever admitted, so hit/byte accounting matches the
simulator's definition of "no caches".
"""
from __future__ import annotations

import dataclasses
import importlib
import sys
import threading
import time
from typing import Any, Callable, Optional, Protocol, runtime_checkable

import torch

from repro_torch.core.cache import EvictionPolicy
from repro_torch.core.objects import DataObject
from repro_torch.core.policies import DispatchPolicy
from repro_torch.core.provisioner import (AllocationPolicy,
                                          DynamicResourceProvisioner)
from repro_torch.core.runtime import SHAPE_ONLY_PAYLOAD, DiffusionRuntime
from repro_torch.core.simulator import DiffusionSim, SimConfig, SimResult
from repro_torch.core.testbeds import TESTBEDS
from repro_torch.workloads import (ARRIVALS, POPULARITY, MetricsCollector,
                                   Workload, build_dag, generate)

from .report import RunReport, build_report
from .spec import (ExperimentSpec, ProvisionerSpec, WorkloadSpec,
                   check_alias_map)


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


def build_provisioner(pspec: ProvisionerSpec,
                      allocate_quantum: int = 1) -> DynamicResourceProvisioner:
    """The DRP a spec's provisioner binding describes, field for field."""
    return DynamicResourceProvisioner(
        min_executors=pspec.min_executors,
        max_executors=pspec.max_executors,
        policy=AllocationPolicy(pspec.policy),
        additive_k=pspec.additive_k,
        queue_threshold=pspec.queue_threshold,
        idle_timeout_s=pspec.idle_timeout_s,
        trigger_cooldown_s=pspec.trigger_cooldown_s,
        allocate_quantum=allocate_quantum)


def build_sim_config(spec: ExperimentSpec,
                     provisioner: Optional[DynamicResourceProvisioner] = None,
                     ) -> SimConfig:
    """The exact `SimConfig` the reference builds -- every aliased knob
    passed explicitly (spec defaults win; see spec.DOCUMENTED_DIVERGENCES)."""
    return SimConfig(
        testbed=TESTBEDS[spec.cluster.testbed],
        n_nodes=spec.cluster.n_nodes,
        policy=DispatchPolicy(spec.policy),
        cpus_per_node=spec.cluster.cpus_per_node,
        cache_policy=EvictionPolicy(spec.cache.eviction),
        cache_capacity_bytes=spec.cache.capacity_bytes,
        caching_enabled=spec.cache.enabled,
        write_outputs_to=spec.write_outputs_to,
        index_update_interval_s=spec.index_update_interval_s,
        release_policy=spec.release_policy,
        flow_solver=spec.flow_solver,
        speculation_factor=spec.speculation_factor,
        provisioner=provisioner,
        provisioner_period_s=(spec.provisioner.period_s
                              if spec.provisioner else 1.0),
        seed=spec.seed)


def _reject(engine: str, knob: str, value, supported) -> None:
    raise ValueError(
        f"spec sets {knob}={value!r}, which the {engine} engine does not "
        f"support (it honours {knob} only as {supported}; see "
        f"repro_torch.experiments.spec.ALIASES).  Refusing to run rather "
        f"than silently ignoring the knob.")


def resolve_task_fn(name: str) -> Callable[..., Any]:
    """A task callable named ``module:attr`` (e.g.
    ``repro_torch.apps.astro:stack_object``)."""
    module, sep, attr = name.partition(":")
    if not sep or not module or not attr:
        raise ValueError(f"task fn name {name!r} is not 'module:attr'")
    return getattr(importlib.import_module(module), attr)


# --------------------------------------------------------------------------
# the Engine protocol + adapters
# --------------------------------------------------------------------------

@runtime_checkable
class Engine(Protocol):
    """prepare(spec) -> run(**kw) -> RunReport -> shutdown()."""

    name: str

    def prepare(self, spec: ExperimentSpec,
                workload: Optional[Workload] = None) -> "Engine": ...

    def run(self, **kwargs) -> RunReport: ...

    def shutdown(self) -> None: ...


class SimEngine:
    """Discrete-event engine adapter.  After ``run()``, ``self.sim`` /
    ``self.result`` / ``self.metrics`` stay available for deep inspection
    (flow logs, dispatcher state).  It runs on the host: the simulator moves
    byte counts, not tensors."""

    name = "sim"

    def __init__(self) -> None:
        self.spec: Optional[ExperimentSpec] = None
        self.sim: Optional[DiffusionSim] = None
        self.workload: Optional[Workload] = None
        self.provisioner: Optional[DynamicResourceProvisioner] = None
        self.result = None
        self.metrics = None

    def prepare(self, spec: ExperimentSpec,
                workload: Optional[Workload] = None) -> "SimEngine":
        check_alias_map()
        if spec.index_update_batch != 1:
            _reject("sim", "index_update_batch", spec.index_update_batch,
                    "the runtime's loose-coherence knob "
                    "(sim uses index_update_interval_s)")
        self.spec = spec
        self.provisioner = (build_provisioner(spec.provisioner)
                            if spec.provisioner else None)
        self.cfg = build_sim_config(spec, self.provisioner)
        self.sim = DiffusionSim(self.cfg)
        self.workload = workload if workload is not None \
            else build_workload(spec.workload)
        return self

    def run(self, until: float = float("inf")) -> RunReport:
        if self.sim is None:
            raise RuntimeError("call prepare(spec) before run()")
        t0 = time.perf_counter()
        self.sim.submit_workload(self.workload)
        r = self.sim.run(until)
        wall = time.perf_counter() - t0
        tb = TESTBEDS[self.spec.cluster.testbed]
        m = MetricsCollector(tb, cpus_per_node=self.cfg.cpus_per_node).collect(
            r, n_submitted=self.sim.n_submitted)
        self.result, self.metrics = r, m
        prov = self.provisioner
        return build_report(
            self.spec, self.name, r, m, wall_s=wall,
            n_allocated=prov.n_allocated if prov else 0,
            n_released=prov.n_released if prov else 0)

    def shutdown(self) -> None:
        """Nothing to release: the event loop owns no threads."""


class _ProvisionerDriver(threading.Thread):
    """Wall-clock DRP tick loop for the threaded runtime: the counterpart
    of `DiffusionSim._provision_tick`.  The spec's provisioner times
    (period, idle timeout, cooldown) are workload seconds, mapped onto the
    wall clock by ``time_scale`` exactly like arrival pacing -- all three
    scale together, so sim and runtime release on the same workload clock.
    With ``time_scale=0`` (as-fast-as-possible) there is no workload clock
    and the raw values are used as wall seconds.  Executor startup is
    immediate (threads, not cluster nodes).

    A failed grow or release is printed and the loop carries on, as in the
    reference; ``failures`` keeps each one's message, so a caller that must
    not miss one (a device allocation that failed) can check it."""

    def __init__(self, rt: DiffusionRuntime,
                 prov: DynamicResourceProvisioner, period_s: float) -> None:
        super().__init__(daemon=True, name="runtime-provisioner")
        self.rt, self.prov = rt, prov
        self.period_s = max(period_s, 0.01)
        self.stop_evt = threading.Event()
        self.failures: list[str] = []

    def run(self) -> None:
        while not self.stop_evt.wait(self.period_s):
            now = time.monotonic()
            with self.rt._lock:
                queue_len = self.rt.dispatcher.queue_len
                live = len(self.rt.workers)
                idle = self.rt.provision_idle(now, self.prov.idle_timeout_s)
            acts = self.prov.step(now, queue_len, live, 0, idle)
            # provisioning silently stopping for the rest of the run is
            # strictly worse than one missed allocation: report and go on
            try:
                self.rt.provision_grow(acts.allocate)
                self.rt.provision_release(acts.release)
            except Exception as e:  # noqa: BLE001
                msg = f"{type(e).__name__}: {e}"
                self.failures.append(msg)
                print(f"runtime-provisioner: provisioning action failed "
                      f"({msg}); continuing", file=sys.stderr)

    def stop(self) -> None:
        self.stop_evt.set()


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
        self.provisioner: Optional[DynamicResourceProvisioner] = None
        self.task_fn_name = task_fn_name
        self.device = device
        self._driver: Optional[_ProvisionerDriver] = None
        self.result = None
        self.metrics = None

    @property
    def provision_failures(self) -> list[str]:
        """Messages of the grow/release actions that failed in ``run()``
        (the driver reports and carries on, as the reference's does)."""
        return list(self._driver.failures) if self._driver else []

    def prepare(self, spec: ExperimentSpec,
                workload: Optional[Workload] = None) -> "RuntimeEngine":
        check_alias_map()
        if spec.cluster.cpus_per_node != 1:
            _reject("runtime", "cluster.cpus_per_node",
                    spec.cluster.cpus_per_node, "1 (workers are 1-slot)")
        if spec.write_outputs_to != "local":
            _reject("runtime", "write_outputs_to", spec.write_outputs_to,
                    "'local' (outputs land in the worker cache)")
        if spec.index_update_interval_s != 0.0:
            _reject("runtime", "index_update_interval_s",
                    spec.index_update_interval_s,
                    "0.0 (the runtime batches by count: index_update_batch)")
        if spec.release_policy != "discard":
            _reject("runtime", "release_policy", spec.release_policy,
                    "'discard' (removed workers drop their caches)")
        if spec.flow_solver != "incremental":
            _reject("runtime", "flow_solver", spec.flow_solver,
                    "'incremental' (there is no fluid-flow clock)")
        if spec.speculation_factor != 0.0:
            _reject("runtime", "speculation_factor", spec.speculation_factor,
                    "0.0 (no speculative twins in the threaded runtime)")
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
        if self.spec.provisioner is not None:
            # DRP built here, not in prepare(): its time knobs depend on
            # this run's time_scale (see _ProvisionerDriver docstring).
            # Scale the spec, then reuse build_provisioner -- one
            # construction path for both engines.
            ps = self.spec.provisioner
            ts = time_scale if time_scale > 0 else 1.0
            self.provisioner = build_provisioner(dataclasses.replace(
                ps, idle_timeout_s=ps.idle_timeout_s * ts,
                trigger_cooldown_s=ps.trigger_cooldown_s * ts))
            self._driver = _ProvisionerDriver(rt, self.provisioner,
                                              ps.period_s * ts)
            self._driver.start()
        t0 = time.monotonic()
        submitter = rt.submit_workload(
            self.workload, task_fn=task_fn,
            payload_factory=payload_factory, time_scale=time_scale,
            barrier_every=barrier_every)
        submitter.join(timeout)
        drained = (not submitter.is_alive()
                   and rt.wait(max(timeout - (time.monotonic() - t0), 0.01)))
        if self._driver is not None:
            self._driver.stop()
            self._driver.join(5.0)
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
        prov = self.provisioner
        return build_report(
            self.spec, self.name, r, m, wall_s=wall,
            n_allocated=prov.n_allocated if prov else 0,
            n_released=prov.n_released if prov else 0,
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
        if self._driver is not None:
            self._driver.stop()
        if self.runtime is not None:
            self.runtime.shutdown()


#: engine registry (the sweep runner binds engines by name)
ENGINES: dict[str, type] = {"sim": SimEngine, "runtime": RuntimeEngine}


def engine_names() -> list[str]:
    """Every engine name make_engine accepts."""
    return sorted(ENGINES)


def make_engine(name: str):
    if name in ENGINES:
        return ENGINES[name]()
    raise ValueError(f"unknown engine {name!r} (known: {engine_names()})")


def run_experiment(spec: ExperimentSpec, engine: str = "sim",
                   workload: Optional[Workload] = None, **run_kw) -> RunReport:
    """One-shot convenience: build the named engine, prepare, run.

    An engine named by string is owned here and shut down before
    returning (the threaded runtime's workers must not outlive the run);
    pass an engine *instance* instead to keep it alive for inspection (or
    to run the runtime on another device than its default ``"cuda"``).
    """
    owned = isinstance(engine, str)
    eng = make_engine(engine) if owned else engine
    try:
        eng.prepare(spec, workload=workload)
        return eng.run(**run_kw)
    finally:
        if owned:
            eng.shutdown()
