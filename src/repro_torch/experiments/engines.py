"""Engine adapters: one `ExperimentSpec` -> either engine -> one `RunReport`.

  SimEngine      discrete-event `DiffusionSim` (simulated clock)
  RuntimeEngine  threaded `DiffusionRuntime` (wall clock, real payloads),
                 its executor caches on ``device`` (default ``"cuda"``);
                 with ``spec.hosts > 0`` it drives `repro_torch.fleet.
                 FleetRuntime` instead -- same executors-and-dispatcher
                 model, spread over OS processes, each on ``device``
  serve          `repro_torch.serve.diffusion.ServeDiffusionEngine`, the
                 runtime engine with serving's checks (``LAZY_ENGINES``)

Counterpart of ``repro.experiments.engines`` for those engines.  All
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
from repro_torch.fleet.host import resolve_task_fn
from repro_torch.obs import Recorder, outcome_record
from repro_torch.workloads import (ARRIVALS, POPULARITY, MetricsCollector,
                                   Workload, build_dag, build_sessions,
                                   generate, replay)

from .report import RunReport, build_report
from .spec import (ExperimentSpec, ProvisionerSpec, WorkloadSpec,
                   check_alias_map)


def build_workload(wspec: WorkloadSpec) -> Workload:
    """Materialise the workload a spec binds: replay its trace, or run the
    generator recipe (bit-identical to calling ``workloads.generate`` with
    the same arguments -- the binding dicts ARE constructor kwargs)."""
    if wspec.trace_path is not None:
        return replay(wspec.trace_path)
    if wspec.dag is not None:
        return build_dag(wspec.dag, name=wspec.name)
    if wspec.sessions is not None:
        return build_sessions(wspec.sessions, name=wspec.name)
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
    """The DRP a spec's provisioner binding describes, field for field.
    ``allocate_quantum`` stays an engine-placement detail (fleet runs pass
    threads_per_host so DRP grow/shrink moves whole hosts)."""
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


def build_recorder(spec: ExperimentSpec) -> Optional[Recorder]:
    """The engine-side half of ``spec.observe``: None with events off (the
    hot paths then carry only a None-check), a bounded drop-oldest ring
    otherwise.  Both adapters install the same object on their dispatcher,
    runtime/sim and provisioner, so one ring holds the whole run."""
    if not spec.observe.events:
        return None
    return Recorder(spec.observe.ring_capacity)


def build_telemetry(spec: ExperimentSpec):
    """The engine-side half of ``spec.observe.metrics_*`` (DESIGN.md §13):
    None with telemetry off, otherwise a `Telemetry` bundle with a
    `HealthMonitor` attached.  Engines hand ``bundle.registry`` to the hot
    paths and call ``record_sample`` on their own clock."""
    if not spec.observe.metrics:
        return None
    from repro_torch.obs import HealthMonitor, Telemetry

    return Telemetry(interval_s=spec.observe.metrics_interval_s,
                     sink_path=spec.observe.metrics_sink_path,
                     health=HealthMonitor())


def _telemetry_summary(telemetry, recorder: Optional[Recorder]) -> dict:
    """The RunReport.telemetry payload: the final central snapshot, the
    final per-host snapshots and their cluster fold, the health-event log,
    and the recorder drop count.  ``recorder_dropped`` is included whenever
    a recorder ran -- even with the metrics plane off -- so a truncated
    event ring is never silent."""
    out: dict = {}
    if recorder is not None:
        out["recorder_dropped"] = recorder.dropped
    if telemetry is not None:
        last = telemetry.series[-1] if telemetry.series else {}
        out["metrics"] = last.get("metrics", {})
        out["hosts"] = last.get("hosts", {})
        out["merged"] = telemetry.merged_last()
        out["n_samples"] = len(telemetry.series)
        out["health_events"] = list(telemetry.health_events)
    return out


def _finish_observe(spec: ExperimentSpec, recorder: Optional[Recorder]) -> None:
    """Post-run sink: dump the ring to ``observe.sink_path`` if bound."""
    if recorder is not None and spec.observe.sink_path is not None:
        recorder.dump(spec.observe.sink_path)


def _reject(engine: str, knob: str, value, supported) -> None:
    raise ValueError(
        f"spec sets {knob}={value!r}, which the {engine} engine does not "
        f"support (it honours {knob} only as {supported}; see "
        f"repro_torch.experiments.spec.ALIASES).  Refusing to run rather "
        f"than silently ignoring the knob.")


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
        self.recorder: Optional[Recorder] = None
        self.telemetry = None
        self.tel_server = None
        self.last_outcomes: Optional[list[dict]] = None

    def prepare(self, spec: ExperimentSpec,
                workload: Optional[Workload] = None) -> "SimEngine":
        check_alias_map()
        if spec.index_update_batch != 1:
            _reject("sim", "index_update_batch", spec.index_update_batch,
                    "the runtime's loose-coherence knob "
                    "(sim uses index_update_interval_s)")
        if spec.hosts != 0:
            _reject("sim", "hosts", spec.hosts,
                    "0 (process layout is a threaded-runtime concern; the "
                    "simulator has no OS processes to spread over)")
        self.spec = spec
        self.recorder = build_recorder(spec)
        self.provisioner = (build_provisioner(spec.provisioner)
                            if spec.provisioner else None)
        self.cfg = build_sim_config(spec, self.provisioner)
        # installed on the config BEFORE construction: the sim ctor swaps
        # the recorder clock to the simulated clock and hands the recorder
        # to its dispatcher
        self.cfg.recorder = self.recorder
        if self.provisioner is not None:
            self.provisioner.recorder = self.recorder
        # telemetry rides the same pre-construction path: the sim ctor
        # installs the registry on its dispatcher/provisioner and schedules
        # the virtual-time sampling tick
        self.telemetry = build_telemetry(spec)
        self.cfg.metrics = self.telemetry
        if self.telemetry is not None and spec.observe.metrics_port >= 0:
            from repro_torch.obs import TelemetryServer

            self.tel_server = TelemetryServer(self.telemetry,
                                              port=spec.observe.metrics_port)
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
        # measured (here: simulated) per-task outcomes -- sim clocks are
        # already run-relative, no rebasing
        self.last_outcomes = [outcome_record(t) for t in r.dispatcher.completed]
        _finish_observe(self.spec, self.recorder)
        telemetry = None
        if self.telemetry is not None:
            # one settled final sample at the virtual end time, so the
            # report's snapshot reconciles exactly with the run's totals
            self.sim.sample_metrics()
            self.telemetry.record_sample(self.sim.loop.now)
            telemetry = _telemetry_summary(self.telemetry, self.recorder)
            self.telemetry.close()
        elif self.recorder is not None:
            telemetry = _telemetry_summary(None, self.recorder)
        prov = self.provisioner
        return build_report(
            self.spec, self.name, r, m, wall_s=wall,
            n_allocated=prov.n_allocated if prov else 0,
            n_released=prov.n_released if prov else 0,
            telemetry=telemetry)

    def shutdown(self) -> None:
        """Close the status endpoint if one was bound (the event loop owns
        no threads of its own)."""
        if self.tel_server is not None:
            self.tel_server.close()
            self.tel_server = None


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


class _TelemetrySampler(threading.Thread):
    """Wall-clock telemetry tick for the threaded runtime (counterpart of
    `DiffusionSim._metrics_tick`): every ``telemetry.interval_s`` it
    refreshes the runtime's gauges, lets the engine add its own
    (`_engine_gauges`), folds in the fleet's per-host cluster view when
    there is one, and records one sample stamped in run-relative seconds."""

    def __init__(self, eng: "RuntimeEngine", t0: float) -> None:
        super().__init__(daemon=True, name="telemetry-sampler")
        self.eng = eng
        self.t0 = t0
        self.stop_evt = threading.Event()

    def sample_once(self) -> None:
        eng = self.eng
        eng.runtime.sample_metrics()
        eng._engine_gauges()
        per_host = None
        manager = getattr(eng.runtime, "manager", None)
        if manager is not None:
            per_host = manager.cluster.per_host()
        eng.telemetry.record_sample(time.monotonic() - self.t0,
                                    per_host=per_host)

    def run(self) -> None:
        while not self.stop_evt.wait(self.eng.telemetry.interval_s):
            self.sample_once()

    def stop(self) -> None:
        self.stop_evt.set()


class RuntimeEngine:
    """Threaded-runtime adapter.  ``run()`` paces the workload in (see
    `DiffusionRuntime.submit_workload`), drains it, and reports in wall
    seconds.  ``self.runtime`` stays alive afterwards for payload/result
    inspection; call :meth:`shutdown` when done.

    ``spec.hosts > 0`` selects fleet mode: the SAME adapter drives a
    `repro_torch.fleet.FleetRuntime` (executors spread over OS processes)
    -- placement, accounting and the report pipeline are identical, only
    the pool's process layout changes.  Task callables cannot cross
    process boundaries, so fleet runs take ``task_fn_name`` (resolved
    host-side against ``repro_torch.fleet.TASK_FNS`` or as
    ``module:attr``) instead of ``run(task_fn=...)``.

    ``device`` defaults to ``"cuda"`` (the executors' caches and every task
    input live there, in every host of a fleet); pass ``device="cpu"`` to
    run on the CPU."""

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
        self.recorder: Optional[Recorder] = None
        self.telemetry = None
        self.tel_server = None
        self._sampler: Optional[_TelemetrySampler] = None
        self.last_outcomes: Optional[list[dict]] = None

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
        self.recorder = build_recorder(spec)
        self.telemetry = build_telemetry(spec)
        if self.telemetry is not None and spec.observe.metrics_port >= 0:
            from repro_torch.obs import TelemetryServer

            self.tel_server = TelemetryServer(self.telemetry,
                                              port=spec.observe.metrics_port)
        if spec.hosts > 0:
            from repro_torch.fleet import FleetRuntime

            self.runtime = FleetRuntime(
                hosts=spec.hosts,
                threads_per_host=spec.threads_per_host,
                policy=DispatchPolicy(spec.policy),
                cache_policy=EvictionPolicy(spec.cache.eviction),
                cache_capacity_bytes=(spec.cache.capacity_bytes
                                      if spec.cache.enabled else 0),
                seed=spec.seed,
                index_update_batch=spec.index_update_batch,
                wire_batch=spec.wire_batch,
                local_dispatch=spec.local_dispatch,
                task_fn_name=self.task_fn_name,
                recorder=self.recorder,
                metrics=self.telemetry,
                device=self.device)
        else:
            self.runtime = DiffusionRuntime(
                n_executors=spec.cluster.n_nodes,
                policy=DispatchPolicy(spec.policy),
                cache_policy=EvictionPolicy(spec.cache.eviction),
                cache_capacity_bytes=(spec.cache.capacity_bytes
                                      if spec.cache.enabled else 0),
                seed=spec.seed,
                index_update_batch=spec.index_update_batch,
                recorder=self.recorder,
                metrics=self.telemetry,
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
        if task_fn is not None and self.spec.hosts > 0:
            raise ValueError(
                "fleet runs cannot ship a task callable over the wire; "
                "construct RuntimeEngine(task_fn_name=...) so each host "
                "resolves it from repro_torch.fleet.TASK_FNS / module:attr")
        if task_fn is None and self.task_fn_name and self.spec.hosts == 0:
            # the named-callable surface works identically on the thread
            # pool (resolved here) and the fleet (resolved host-side) --
            # silently dropping the name would run every task shape-only
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
            self.provisioner = build_provisioner(
                dataclasses.replace(
                    ps, idle_timeout_s=ps.idle_timeout_s * ts,
                    trigger_cooldown_s=ps.trigger_cooldown_s * ts),
                allocate_quantum=(self.spec.threads_per_host
                                  if self.spec.hosts > 0 else 1))
            self.provisioner.recorder = self.recorder
            self._driver = _ProvisionerDriver(rt, self.provisioner,
                                              ps.period_s * ts)
            self._driver.start()
        t0 = time.monotonic()
        if self.telemetry is not None:
            self._sampler = _TelemetrySampler(self, t0)
            self._sampler.start()
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
        if self._sampler is not None:
            self._sampler.stop()
            self._sampler.join(5.0)
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
        # measured per-task outcomes, rebased from the monotonic clock to
        # seconds since run() started (same base as _result_view)
        self.last_outcomes = [outcome_record(t, base=t0)
                              for t in rt.dispatcher.completed]
        _finish_observe(self.spec, self.recorder)
        telemetry = None
        if self.telemetry is not None:
            # settled final sample: on a fleet, first barrier on a fresh
            # post-drain stats frame from every live host so the per-host
            # snapshots in the report reflect the finished run exactly
            if hasattr(rt, "request_stats"):
                rt.request_stats()
            self._sampler.sample_once()
            telemetry = _telemetry_summary(self.telemetry, self.recorder)
            self.telemetry.close()
        elif self.recorder is not None:
            telemetry = _telemetry_summary(None, self.recorder)
        prov = self.provisioner
        return build_report(
            self.spec, self.name, r, m, wall_s=wall,
            n_allocated=prov.n_allocated if prov else 0,
            n_released=prov.n_released if prov else 0,
            dispatch_stats=rt.dispatch_stats(),
            telemetry=telemetry)

    def _engine_gauges(self) -> None:
        """Subclass hook: extra engine-specific gauges per telemetry tick
        (the serve engine reports its KV-reuse byte split here)."""

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
        if self._sampler is not None:
            self._sampler.stop()
        if self.tel_server is not None:
            self.tel_server.close()
            self.tel_server = None
        if self.runtime is not None:
            self.runtime.shutdown()


#: engine registry (the sweep runner binds engines by name)
ENGINES: dict[str, type] = {"sim": SimEngine, "runtime": RuntimeEngine}

#: engines living outside repro_torch.experiments, resolved on first use --
#: repro_torch.serve.diffusion imports back into this module, so
#: registering its class eagerly would be a cycle.  Value = (module, class
#: name).
LAZY_ENGINES: dict[str, tuple[str, str]] = {
    "serve": ("repro_torch.serve.diffusion", "ServeDiffusionEngine"),
}


def engine_names() -> list[str]:
    """Every engine name make_engine accepts."""
    return sorted([*ENGINES, *LAZY_ENGINES])


def make_engine(name: str):
    if name in ENGINES:
        return ENGINES[name]()
    if name in LAZY_ENGINES:
        module, cls = LAZY_ENGINES[name]
        return getattr(importlib.import_module(module), cls)()
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
