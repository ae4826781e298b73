"""Discrete-event simulator for data diffusion (calibrated to §4's testbed).

Executes the *same* Dispatcher / ExecutorCache / LocationIndex / policy code
as the real threaded runtime, replacing task execution and byte movement with
a fluid-flow clock (transport.py).  One simulated executor == one node with
``cpus_per_node`` compute slots (the paper maps executors 1:1 to nodes; the
stacking runs use both CPUs per node).

Task lifecycle (mirrors §3.2.2):
  dispatch (serialized dispatcher CPU + RTT)
  -> [wrapper metadata ops on the store MDS, if any]
  -> per input: local-cache read | peer fetch (GridFTP-analogue) | store read
     (misses are cached locally unless caching is disabled; evictions and
      insertions emit loosely-coherent index updates)
  -> compute (slot-bound, optionally slowed for straggler injection)
  -> outputs written locally / to the store
  -> completion -> dispatcher -> next dispatches.

Fault tolerance exercised here: executor failure at a configured time
(flows cancelled, index invalidated, tasks re-queued), straggler speculation
(dispatcher twins), elastic pool via the DRP.

Submission is either closed-loop (``submit``: a batch lands on the wait
queue at once) or open-loop (``submit_workload``: one heap-scheduled ARRIVAL
event per task at its ``repro_torch.workloads`` arrival time, so queue depth
tracks *demand* and the DRP grows/shrinks the pool against it; pool-size
changes are sampled into ``pool_log`` for the workload metrics layer).

Counterpart of ``repro.core.simulator``: every heap tie-break and every
``random.Random`` draw happens in the reference's order, so a run's report
equals the reference's exactly, and so does its lifecycle event stream when
a recorder is installed.  The simulator moves no tensors; it is the
host-side model the threaded runtime on the card is compared with.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence

from .cache import EvictionPolicy, ExecutorCache
from .index import IndexUpdate
from .objects import DataObject, Task, TaskState
from .policies import DispatchPolicy
from .provisioner import DynamicResourceProvisioner
from .scheduler import Dispatcher, Dispatch
from .testbeds import TestbedSpec
from .transport import BandwidthResource, EventLoop, FifoServer, FlowNetwork, MetadataService


@dataclass(slots=True)
class SimNodeRes:
    eid: str
    disk_read: BandwidthResource
    disk_write: BandwidthResource
    nic_in: BandwidthResource
    nic_out: BandwidthResource
    cache: ExecutorCache
    slowdown: float = 1.0
    alive: bool = True


@dataclass
class SimConfig:
    testbed: TestbedSpec
    n_nodes: int
    policy: DispatchPolicy
    cpus_per_node: int = 1
    cache_policy: EvictionPolicy = EvictionPolicy.LRU
    cache_capacity_bytes: int = 50 * 10**9
    caching_enabled: bool = True          # False => paper's first-available mode
    write_outputs_to: str = "local"       # local | store | none
    index_update_interval_s: float = 0.0  # 0 => synchronous (tight coherence)
    # paper §6 future work: what happens to cached data when an executor is
    # RELEASED (not failed)? "discard" drops it (paper default assumption);
    # "rebalance" migrates it to live peers (beyond-paper), so later tasks
    # still find it via the index instead of re-reading the store.
    release_policy: str = "discard"       # discard | rebalance
    # flow-rate solver: "incremental" (dirty-resource repricing, the default)
    # or "naive" (global rescan per event; retained reference -- see
    # the module docstring of transport.py)
    flow_solver: str = "incremental"
    speculation_factor: float = 0.0
    provisioner: Optional[DynamicResourceProvisioner] = None
    provisioner_period_s: float = 1.0
    seed: int = 0
    executor_slowdown: dict[str, float] = field(default_factory=dict)
    fail_at: dict[str, float] = field(default_factory=dict)
    # optional repro_torch.obs.Recorder (lifecycle events on the simulated
    # clock); None = recording off, zero hot-path cost
    recorder: Optional[object] = None
    # optional repro_torch.obs.metrics.Telemetry bundle; samples are taken
    # on the simulated clock every ``metrics.interval_s`` virtual seconds
    # (same free-when-off contract as the recorder; DESIGN.md §13)
    metrics: Optional[object] = None


@dataclass
class SimResult:
    makespan: float
    t_first_dispatch: float
    t_last_complete: float
    bytes_by_kind: dict[str, float]
    n_completed: int
    n_failed: int
    local_hits: int
    peer_hits: int
    store_reads: int
    dispatcher: Dispatcher
    flow_log: list[tuple[float, float, float, str]]
    # (t, live-executor count) samples; one initial entry, then one per
    # membership change.  MetricsCollector integrates this for the
    # provisioning metrics (executor-seconds, performance index).
    pool_log: list[tuple[float, int]] = field(default_factory=list)

    @property
    def busy_span(self) -> float:
        return max(self.t_last_complete - self.t_first_dispatch, 1e-12)

    def read_throughput(self) -> float:
        """Bytes/s of task input consumption (local + c2c + store reads)."""
        b = self.bytes_by_kind
        total = b.get("local", 0) + b.get("c2c", 0) + b.get("store_read", 0)
        return total / self.busy_span

    def moved_throughput(self) -> float:
        """Bytes/s of all reads+writes (the paper's read+write metric)."""
        return sum(self.bytes_by_kind.values()) / self.busy_span

    def throughput_of(self, kinds: Sequence[str]) -> float:
        return sum(self.bytes_by_kind.get(k, 0) for k in kinds) / self.busy_span

    @property
    def local_hit_ratio(self) -> float:
        n = self.local_hits + self.peer_hits + self.store_reads
        return self.local_hits / n if n else 0.0

    @property
    def global_hit_ratio(self) -> float:
        """Paper's cache-hit metric: any access avoiding persistent storage."""
        n = self.local_hits + self.peer_hits + self.store_reads
        return (self.local_hits + self.peer_hits) / n if n else 0.0

    def tasks_per_second(self) -> float:
        return self.n_completed / self.busy_span


class DiffusionSim:
    def __init__(self, cfg: SimConfig) -> None:
        self.cfg = cfg
        tb = cfg.testbed
        self.loop = EventLoop()
        self.net = FlowNetwork(self.loop, solver=cfg.flow_solver)
        self.store_read = BandwidthResource("store_read", tb.store_read_bw)
        self.store_write = BandwidthResource("store_write", tb.store_write_bw)
        self.store_meta = MetadataService(self.loop, tb.store_meta_latency_s)
        self.dispatch_cpu = FifoServer(self.loop, tb.dispatch_service_s)
        self.dispatcher = Dispatcher(
            cfg.policy, speculation_factor=cfg.speculation_factor)
        self.recorder = cfg.recorder
        if self.recorder is not None:
            # events are stamped on the simulated clock, so sim and runtime
            # traces line up phase-for-phase (not second-for-second)
            self.recorder.clock = lambda: self.loop.now
            self.dispatcher.recorder = self.recorder
        self.telemetry = cfg.metrics
        self.metrics = cfg.metrics.registry if cfg.metrics is not None else None
        self.dispatcher.metrics = self.metrics
        if cfg.provisioner is not None:
            cfg.provisioner.metrics = self.metrics
        self.nodes: dict[str, SimNodeRes] = {}
        self.store_catalog: dict[str, DataObject] = {}
        self._rng = random.Random(cfg.seed)
        self._pending_updates: dict[str, list[IndexUpdate]] = {}
        self._task_gen: dict[str, int] = {}
        self._task_flows: dict[str, list[int]] = {}
        self._inflight_alloc = 0
        self._next_node_id = 0
        self._t_first_dispatch: Optional[float] = None
        self._t_last_complete = 0.0
        self.local_hits = 0
        self.peer_hits = 0
        self.store_reads = 0
        self.pool_log: list[tuple[float, int]] = []
        self.n_submitted = 0
        for _ in range(cfg.n_nodes):
            self._add_node(0.0)
        self._log_pool(0.0)
        for eid, t in cfg.fail_at.items():
            self.loop.at(t, lambda now, e=eid: self._fail_node(e, now))
        self._prov_tick_live = False
        if cfg.provisioner is not None:
            self._prov_tick_live = True
            self.loop.after(cfg.provisioner_period_s, self._provision_tick)
        if cfg.speculation_factor > 0:
            self.loop.after(1.0, self._speculation_tick)
        self._metrics_tick_live = False
        if self.telemetry is not None:
            self._metrics_tick_live = True
            self.loop.after(self.telemetry.interval_s, self._metrics_tick)

    # ------------- membership -------------------------------------------------
    def _log_pool(self, now: float) -> None:
        live = sum(1 for n in self.nodes.values() if n.alive)
        self.pool_log.append((now, live))
        if self.recorder is not None:
            self.recorder.emit("pool", t=now, size=live)

    def _add_node(self, now: float) -> str:
        tb = self.cfg.testbed
        eid = f"e{self._next_node_id}"
        self._next_node_id += 1
        self.nodes[eid] = SimNodeRes(
            eid=eid,
            disk_read=BandwidthResource(f"{eid}.dr", tb.disk_read_bw),
            disk_write=BandwidthResource(f"{eid}.dw", tb.disk_write_bw),
            nic_in=BandwidthResource(f"{eid}.ni", tb.nic_in_bw),
            nic_out=BandwidthResource(f"{eid}.no", tb.nic_out_bw),
            cache=ExecutorCache(self.cfg.cache_capacity_bytes,
                                self.cfg.cache_policy,
                                seed=self.cfg.seed + self._next_node_id),
            slowdown=self.cfg.executor_slowdown.get(eid, 1.0),
        )
        self.dispatcher.executor_joined(eid, now, slots=self.cfg.cpus_per_node)
        self._pending_updates[eid] = []
        return eid

    def _fail_node(self, eid: str, now: float) -> None:
        node = self.nodes.get(eid)
        if node is None or not node.alive:
            return
        node.alive = False
        node.cache.drop_all()
        st = self.dispatcher.executors.get(eid)
        running = list(st.running) if st else []
        for tid in running:
            # invalidate the in-flight attempt: its queued events must not
            # complete the (re-queued) task a second time
            self._task_gen[tid] = self._task_gen.get(tid, 0) + 1
            for fid in self._task_flows.pop(tid, []):
                self.net.cancel(fid)
        self.dispatcher.executor_left(eid, now, failed=True)
        self._log_pool(now)
        self._pump(now)

    def _release_node(self, eid: str, now: float) -> None:
        node = self.nodes.get(eid)
        if node is None or not node.alive:
            return
        node.alive = False
        if self.cfg.release_policy == "rebalance":
            # migrate cached objects to live peers (round-robin), charging
            # the network: one c2c flow per object.  Index follows the data.
            peers = sorted(e for e, n in self.nodes.items()
                           if n.alive and e != eid)
            if peers:
                for i, oid in enumerate(sorted(node.cache.contents())):
                    dst = self.nodes[peers[i % len(peers)]]
                    size = node.cache.size_of(oid)
                    obj = self.store_catalog.get(oid) or DataObject(oid, size)
                    evicted = dst.cache.put(obj)
                    self._emit_update(dst.eid, IndexUpdate(
                        dst.eid, added=(oid,), removed=tuple(evicted)), now)
                    self.net.start(size, (node.nic_out, dst.nic_in),
                                   lambda tt: None, kind="c2c")
        node.cache.drop_all()
        self.dispatcher.executor_left(eid, now, failed=False)
        self._log_pool(now)

    # ------------- data placement ----------------------------------------------
    def add_objects(self, objs: Iterable[DataObject]) -> None:
        for ob in objs:
            self.store_catalog[ob.oid] = ob
        self.dispatcher.register_objects(self.store_catalog.values())

    def warm_caches(self, objs: Sequence[DataObject], replicas: int = 1) -> None:
        """Round-robin pre-population (the paper's untimed warm-up runs)."""
        eids = sorted(self.nodes)
        for i, ob in enumerate(objs):
            for r in range(replicas):
                eid = eids[(i + r) % len(eids)]
                self.nodes[eid].cache.put(ob)
                # route through the dispatcher hook so its incremental
                # placement state stays coherent with the index
                self.dispatcher.apply_index_updates(
                    (IndexUpdate(eid, added=(ob.oid,)),))

    # ------------- submission / run ----------------------------------------------
    def submit(self, tasks: Iterable[Task]) -> None:
        ts = list(tasks)
        self.dispatcher.submit(ts, self.loop.now)
        self.n_submitted += len(ts)
        for t in ts:
            self._task_gen.setdefault(t.tid, 0)
        # resurrect the provisioner tick if it parked after a drained run
        if self.cfg.provisioner is not None and not self._prov_tick_live:
            self._prov_tick_live = True
            self.loop.after(self.cfg.provisioner_period_s, self._provision_tick)
        if self.telemetry is not None and not self._metrics_tick_live:
            self._metrics_tick_live = True
            self.loop.after(self.telemetry.interval_s, self._metrics_tick)
        self._pump(self.loop.now)

    def submit_workload(self, wl) -> int:
        """Open-loop submission: register the workload's catalog and heap-
        schedule one ARRIVAL event per task at its arrival time.  The wait
        queue then reflects *demand* rather than a pre-staged batch, which
        is what drives the DynamicResourceProvisioner's grow/shrink cycle.
        Returns the number of arrivals scheduled."""
        self.add_objects(wl.objects)
        n = 0
        for t_arr, task in wl.tasks():
            self.loop.at(t_arr, lambda now, tk=task: self.submit((tk,)))
            n += 1
        return n

    def run(self, until: float = float("inf")) -> SimResult:
        self.loop.run(until)
        d = self.dispatcher
        return SimResult(
            makespan=self.loop.now,
            t_first_dispatch=self._t_first_dispatch or 0.0,
            t_last_complete=self._t_last_complete,
            bytes_by_kind=dict(self.net.bytes_by_kind),
            n_completed=len(d.completed),
            n_failed=len(d.failed),
            local_hits=self.local_hits,
            peer_hits=self.peer_hits,
            store_reads=self.store_reads,
            dispatcher=d,
            flow_log=self.net.flow_log,
            pool_log=list(self.pool_log),
        )

    # ------------- scheduling pump -----------------------------------------------
    def _pump(self, now: float) -> None:
        dispatches = self.dispatcher.next_dispatches(now)
        if self.recorder is not None:
            self.recorder.emit("pump", t=now, n=len(dispatches),
                               queue=self.dispatcher.queue_len)
        if self.metrics is not None:
            # no pump-latency histogram here: virtual time has no meaningful
            # dispatcher CPU hold (the FifoServer models it explicitly)
            self.metrics.inc("sched.pump_calls")
            if dispatches:
                self.metrics.inc("sched.dispatches", len(dispatches))
        for disp in dispatches:
            cost = self.cfg.testbed.dispatch_service_s
            if self.cfg.policy.ships_hints:
                cost += len(disp.task.inputs) * self.cfg.testbed.index_lookup_s
            self.dispatch_cpu.submit(
                lambda t, d=disp: self.loop.after(
                    self.cfg.testbed.dispatch_rtt_s,
                    lambda t2, d=d: self._start_task(d, t2)),
                cost_s=cost,
            )

    def _start_task(self, disp: Dispatch, now: float) -> None:
        t = disp.task
        if t.state is TaskState.DONE:   # satisfied by a speculative twin
            self.dispatcher.task_finished(t, now, ok=True)
            return
        gen = self._task_gen.get(t.tid, 0) + 1
        self._task_gen[t.tid] = gen
        node = self.nodes.get(disp.executor)
        if node is None or not node.alive:
            self.dispatcher.task_finished(t, now, ok=False)
            self._pump(now)
            return
        if self._t_first_dispatch is None:
            self._t_first_dispatch = now
        t.state = TaskState.FETCHING
        t.start_time = now
        self._task_flows[t.tid] = []
        if t.store_metadata_ops > 0:
            self.store_meta.submit(
                t.store_metadata_ops,
                lambda tt, t=t, n=node, g=gen: self._fetch_inputs(t, n, 0, g, tt))
        else:
            self._fetch_inputs(t, node, 0, gen, now)

    # ------------- input staging -----------------------------------------------
    def _fetch_inputs(self, t: Task, node: SimNodeRes, i: int, gen: int,
                      now: float) -> None:
        if self._task_gen.get(t.tid, 0) != gen:
            return
        if i >= len(t.inputs):
            self._compute(t, node, gen, now)
            return
        oid = t.inputs[i]
        size = self.store_catalog[oid].size_bytes if oid in self.store_catalog \
            else self.dispatcher.sizes.get(oid, 0)
        nxt = lambda tt, t=t, n=node, i=i, g=gen: self._fetch_inputs(t, n, i + 1, g, tt)

        if self.cfg.caching_enabled and node.cache.get(oid):
            node.cache.pin(oid)
            self.local_hits += 1
            t.cache_hits += 1
            t.bytes_local += size
            if self.recorder is not None:
                self.recorder.emit("input", t=now, tid=t.tid, eid=node.eid,
                                   oid=oid, source="local", bytes=size)
            fid = self.net.start(
                size, (node.disk_read,),
                lambda tt, t=t, n=node, o=oid, f=nxt: (n.cache.unpin(o), f(tt)),
                kind="local")
            self._task_flows[t.tid].append(fid)
            return

        t.cache_misses += 1
        # peer fetch using the dispatcher-shipped hints (no extra lookups at
        # the executor -- §3.2.2), falling back to the store on staleness.
        peers = [p for p in t.location_hints.get(oid, ())
                 if p != node.eid and p in self.nodes and self.nodes[p].alive
                 and oid in self.nodes[p].cache]
        if peers:
            src = self.nodes[self._rng.choice(sorted(peers))]
            src.cache.pin(oid)
            self.peer_hits += 1
            t.peer_hits += 1
            t.bytes_cache_to_cache += size
            if self.recorder is not None:
                self.recorder.emit("input", t=now, tid=t.tid, eid=node.eid,
                                   oid=oid, source="peer", bytes=size,
                                   peer=src.eid)
            tb = self.cfg.testbed

            def done_peer(tt, t=t, n=node, o=oid, s=src, sz=size, f=nxt):
                s.cache.unpin(o)
                self._admit(n, o, sz, tt, f)

            self.loop.after(
                tb.peer_setup_latency_s,
                lambda tt, sz=size, s=src, n=node, cb=done_peer: self._task_flows[t.tid].append(
                    self.net.start(sz, (s.disk_read, s.nic_out, n.nic_in),
                                   cb, kind="c2c", flow_cap=tb.peer_flow_cap)))
            return

        # persistent store read
        self.store_reads += 1
        t.bytes_store += size
        if self.recorder is not None:
            self.recorder.emit("input", t=now, tid=t.tid, eid=node.eid,
                               oid=oid, source="store", bytes=size)
        tb = self.cfg.testbed

        def done_store(tt, t=t, n=node, o=oid, sz=size, f=nxt):
            self._admit(n, o, sz, tt, f)

        self.loop.after(
            tb.store_open_latency_s,
            lambda tt, sz=size, n=node, cb=done_store: self._task_flows[t.tid].append(
                self.net.start(sz, (self.store_read, n.nic_in), cb,
                               kind="store_read")))

    def _admit(self, node: SimNodeRes, oid: str, size: int, now: float, then) -> None:
        """Write a fetched object into the local cache (if enabled)."""
        if not self.cfg.caching_enabled:
            then(now)
            return
        obj = self.store_catalog.get(oid) or DataObject(oid, size)

        def written(tt):
            evicted = node.cache.put(obj)
            upd = IndexUpdate(node.eid, added=(oid,), removed=tuple(evicted))
            self._emit_update(node.eid, upd, tt)
            node.cache.pin(oid)
            then(tt)

        self.net.start(size, (node.disk_write,), written, kind="local_write")

    def _emit_update(self, eid: str, upd: IndexUpdate, now: float) -> None:
        if self.cfg.index_update_interval_s <= 0:
            # synchronous (tight coherence) path still goes through the
            # dispatcher hook, which patches the queued-task hint cache and
            # the inverted executor->score map incrementally
            self.dispatcher.apply_index_updates((upd,))
            return
        buf = self._pending_updates.setdefault(eid, [])
        if not buf:
            self.loop.after(self.cfg.index_update_interval_s,
                            lambda tt, e=eid: self._flush_updates(e))
        buf.append(upd)

    def _flush_updates(self, eid: str) -> None:
        buf = self._pending_updates.get(eid, [])
        self._pending_updates[eid] = []
        self.dispatcher.apply_index_updates(buf)

    # ------------- compute + outputs --------------------------------------------
    def _compute(self, t: Task, node: SimNodeRes, gen: int, now: float) -> None:
        if self._task_gen.get(t.tid, 0) != gen:
            return
        t.state = TaskState.RUNNING
        if self.recorder is not None:
            self.recorder.emit("exec_start", t=now, tid=t.tid, eid=node.eid)
        dt = (t.compute_seconds + self.cfg.testbed.task_overhead_s) * node.slowdown
        self.loop.after(dt, lambda tt, t=t, n=node, g=gen: self._write_outputs(t, n, 0, g, tt))

    def _write_outputs(self, t: Task, node: SimNodeRes, i: int, gen: int,
                       now: float) -> None:
        if self._task_gen.get(t.tid, 0) != gen:
            return
        if i >= len(t.outputs) or self.cfg.write_outputs_to == "none":
            self._complete(t, node, now)
            return
        ob = t.outputs[i]
        nxt = lambda tt, t=t, n=node, i=i, g=gen: self._write_outputs(t, n, i + 1, g, tt)
        if self.cfg.write_outputs_to == "store":
            fid = self.net.start(ob.size_bytes, (node.nic_out, self.store_write),
                                 nxt, kind="store_write")
        else:
            def written(tt, n=node, ob=ob, f=nxt):
                if self.cfg.caching_enabled:
                    evicted = n.cache.put(ob)
                    self._emit_update(
                        n.eid, IndexUpdate(n.eid, added=(ob.oid,),
                                           removed=tuple(evicted)), tt)
                f(tt)
            fid = self.net.start(ob.size_bytes, (node.disk_write,), written,
                                 kind="local_write")
        self._task_flows[t.tid].append(fid)

    def _complete(self, t: Task, node: SimNodeRes, now: float) -> None:
        for oid in t.inputs:
            node.cache.unpin(oid)
        for ob in t.outputs:
            self.dispatcher.sizes[ob.oid] = ob.size_bytes
        self._task_flows.pop(t.tid, None)
        self._t_last_complete = now
        if self.recorder is not None:
            self.recorder.emit("exec_end", t=now, tid=t.tid, eid=node.eid,
                               ok=True)
        cancel_tid = self.dispatcher.task_finished(t, now, ok=True)
        if cancel_tid is not None:
            self._cancel_task(cancel_tid)
        self._pump(now)

    def _cancel_task(self, tid: str) -> None:
        self._task_gen[tid] = self._task_gen.get(tid, 0) + 1
        for fid in self._task_flows.pop(tid, []):
            self.net.cancel(fid)
        t = self.dispatcher.tasks.get(tid)
        if t is not None and t.executor in self.dispatcher.executors:
            st = self.dispatcher.executors[t.executor]
            if tid in st.running:
                st.busy = max(st.busy - 1, 0)
                st.running.discard(tid)

    # ------------- periodic services ------------------------------------------
    def _provision_tick(self, now: float) -> None:
        prov = self.cfg.provisioner
        assert prov is not None
        live = sum(1 for n in self.nodes.values() if n.alive)
        acts = prov.step(now, self.dispatcher.queue_len, live,
                         self._inflight_alloc,
                         self.dispatcher.idle_executors(
                             now, prov.idle_timeout_s))
        for _ in range(acts.allocate):
            self._inflight_alloc += 1
            self.loop.after(self.cfg.testbed.executor_startup_s,
                            self._alloc_arrived)
        for eid in acts.release:
            self._release_node(eid, now)
        live_after = sum(1 for n in self.nodes.values() if n.alive)
        # keep ticking while work remains OR the pool is above its floor
        # (releases need idle_timeout to elapse after the last completion)
        if (not (self.loop.empty and self.dispatcher.queue_len == 0)
                or live_after > prov.min_executors):
            self.loop.after(self.cfg.provisioner_period_s, self._provision_tick)
        else:
            self._prov_tick_live = False

    def _alloc_arrived(self, now: float) -> None:
        self._inflight_alloc -= 1
        self._add_node(now)
        self._log_pool(now)
        self._pump(now)

    def sample_metrics(self) -> None:
        """Refresh telemetry gauges from current sim state (virtual time)."""
        m = self.metrics
        if m is None:
            return
        live = [n for n in self.nodes.values() if n.alive]
        m.gauge_set("sched.queue_depth", self.dispatcher.queue_len)
        m.gauge_set("pool.size", len(live))
        m.gauge_set("cache.bytes", sum(n.cache.used_bytes for n in live))
        m.gauge_set("cache.hits", sum(n.cache.stats.hits for n in live))
        m.gauge_set("cache.misses", sum(n.cache.stats.misses for n in live))
        m.gauge_set("cache.evictions",
                    sum(n.cache.stats.evictions for n in live))
        m.gauge_set("cache.insertions",
                    sum(n.cache.stats.insertions for n in live))
        m.gauge_set("cache.readmits",
                    sum(n.cache.stats.readmits for n in live))
        b = self.net.bytes_by_kind
        m.gauge_set("bw.bytes_local", int(b.get("local", 0)))
        m.gauge_set("bw.bytes_c2c", int(b.get("c2c", 0)))
        m.gauge_set("bw.bytes_store", int(b.get("store_read", 0)))
        if self.recorder is not None:
            m.gauge_set("obs.recorder_dropped", self.recorder.dropped)

    def _metrics_tick(self, now: float) -> None:
        tel = self.telemetry
        assert tel is not None
        self.sample_metrics()
        tel.record_sample(now)
        # park when the run drained (mirrors the provisioner tick); submit()
        # resurrects it
        if not (self.loop.empty and self.dispatcher.queue_len == 0):
            self.loop.after(tel.interval_s, self._metrics_tick)
        else:
            self._metrics_tick_live = False

    def _speculation_tick(self, now: float) -> None:
        for t in self.dispatcher.speculation_candidates(now):
            twin = self.dispatcher.make_twin(t, now)
            self._task_gen.setdefault(twin.tid, 0)
        self._pump(now)
        if not self.loop.empty or self.dispatcher.queue_len:
            self.loop.after(1.0, self._speculation_tick)
