"""FleetRuntime: the threaded diffusion runtime across OS processes.

Same authoritative scheduling stack as `DiffusionRuntime` -- ONE
`Dispatcher`/`LocationIndex`/policy instance, in this process -- but the
executors live in ``hosts`` separate host processes of
``threads_per_host`` executor threads each (repro_torch.fleet.host), talking
through the two Channel seams:

  dispatch   `_RemoteExecutor.dispatch` serialises each `Dispatch` (task
             shape + input sizes + location hints + peer routes) onto the
             host's socket instead of a thread inbox;
  updates    hosts stream `IndexUpdate`s and attempt completions back; the
             per-host receiver applies them through the SAME `_on_update` /
             `_finish_attempt` code paths the in-process workers use, so
             membership guards, retry accounting and the byte ledger are
             one implementation.

Because placement, hints, retries and accounting never leave this process,
the scheduling behaviour is identical to single-process mode by
construction; the parity tests verify it by replaying a recorded trace
batch-synchronously on both (and on the reference's fleet) and comparing
RunReports field-for-field on the scheduling-determined numbers.

The device: ``device`` (default ``"cuda"``) is resolved here, before any
host is spawned, and every host runs its executor caches and task fns on
it; ``device="cpu"`` runs the hosts on the CPU.  Results stay in the hosts
(``Task.result`` is not shipped back): a task's outputs are read from the
cache of the executor that ran it through that host's peer server
(``PeerClient.fetch``).

Failure semantics: a host that SIGKILLs/EOFs/stops heartbeating is
declared dead once; every executor on it goes through the dispatcher's
``executor_left`` path (in-flight tasks re-queued front-of-line, attempts
bumped, terminally-failed ones accounted so ``wait()`` cannot leak), and
its cached bytes vanish from the index, exactly like a failed thread
worker -- the rest of the fleet re-fetches from peers or the store.

Provisioning is whole-host: the DRP's executor-unit requests are rounded
to ``threads_per_host`` quanta (`DynamicResourceProvisioner.
allocate_quantum`), ``provision_grow`` spawns hosts, and only hosts whose
executors are ALL idle are offered for release.
"""
from __future__ import annotations

import os
import time
from typing import Any, Iterable, Optional

import torch

from repro_torch.core.cache import EvictionPolicy
from repro_torch.core.index import IndexUpdate
from repro_torch.core.objects import DataObject
from repro_torch.core.policies import DispatchPolicy
from repro_torch.core.runtime import (DiffusionRuntime, ObjectStore,
                                      _InputLedger)
from repro_torch.core.scheduler import Dispatch

from .manager import HostHandle, HostManager


class _RemoteExecutor:
    """Central-side proxy for one executor thread on a host.  Lives in
    ``runtime.workers`` exactly where an `ExecutorWorker` would, so every
    inherited code path (pump, membership guard, removal) works unchanged
    -- identity of this object IS the attempt-validity token."""

    __slots__ = ("eid", "host", "rt")

    def __init__(self, eid: str, host: HostHandle, rt: "FleetRuntime") -> None:
        self.eid = eid
        self.host = host
        self.rt = rt

    def task_msg(self, disp: Dispatch) -> dict:
        """Serialise one Dispatch to its wire message (the pump collects
        these per host and ships them as bounded batch frames)."""
        t = disp.task
        routes: dict[str, list] = {}
        for locs in disp.hints.values():
            for peer in locs:
                if peer in routes:
                    continue
                w = self.rt.workers.get(peer)
                if isinstance(w, _RemoteExecutor) and w.host is not self.host:
                    routes[peer] = [w.host.peer_host, w.host.peer_port]
        sizes = self.rt.dispatcher.sizes
        return {
            "t": "task",
            "eid": self.eid,
            "tid": t.tid,
            "inputs": [[oid, sizes.get(oid, 0)] for oid in t.inputs],
            "outputs": [[ob.oid, ob.size_bytes] for ob in t.outputs],
            "hints": {oid: list(locs) for oid, locs in disp.hints.items()},
            "routes": routes,
        }

    def dispatch(self, disp: Dispatch) -> None:
        self.host.send(self.task_msg(disp))

    def stop(self) -> None:
        """Nothing to join centrally; host teardown stops the thread."""


class FleetRuntime(DiffusionRuntime):
    def __init__(
        self,
        hosts: int,
        threads_per_host: int = 1,
        policy: DispatchPolicy = DispatchPolicy.MAX_COMPUTE_UTIL,
        cache_policy: EvictionPolicy = EvictionPolicy.LRU,
        cache_capacity_bytes: int = 1 << 30,
        store: Optional[ObjectStore] = None,
        seed: int = 0,
        index_update_batch: int = 1,
        task_fn_name: Optional[str] = None,
        codec: str = "auto",
        heartbeat_interval_s: float = 0.25,
        heartbeat_timeout_s: float = 3.0,
        spawn_timeout_s: float = 60.0,
        wire_batch: int = 64,
        local_dispatch: bool = False,
        lease_depth: int = 2,
        bind_host: str = "127.0.0.1",
        recorder=None,
        metrics=None,  # optional repro_torch.obs.metrics.Telemetry
        device: str | torch.device = "cuda",
    ) -> None:
        if hosts < 0:
            # hosts=0 builds an empty fleet (unit tests drive the receive
            # path directly; add_host() grows it for real)
            raise ValueError("need hosts >= 0")
        if threads_per_host < 1:
            raise ValueError("need threads_per_host >= 1")
        if wire_batch < 1:
            raise ValueError("need wire_batch >= 1")
        if lease_depth < 1:
            raise ValueError("need lease_depth >= 1")
        self.threads_per_host = threads_per_host
        self.wire_batch = wire_batch
        self.local_dispatch = local_dispatch
        self.lease_depth = lease_depth
        super().__init__(n_executors=0, policy=policy,
                         cache_policy=cache_policy,
                         cache_capacity_bytes=cache_capacity_bytes,
                         store=store, seed=seed,
                         index_update_batch=index_update_batch,
                         recorder=recorder, metrics=metrics, device=device)
        #: host_id -> {tid: Task} parked on a lease, awaiting claim/reclaim
        self._leases: dict[str, dict[str, Any]] = {}
        #: applied index updates pending forward to host replicas
        self._fwd_buf: list[list] = []
        self.manager = HostManager(
            self, codec=codec, task_fn_name=task_fn_name,
            hb_interval_s=heartbeat_interval_s,
            hb_timeout_s=heartbeat_timeout_s,
            spawn_timeout_s=spawn_timeout_s,
            bind_host=bind_host, wire_batch=wire_batch,
            local_dispatch=local_dispatch,
            # hosts mirror the central ring's capacity; 0 keeps host-side
            # recording compiled out entirely (no Recorder import there)
            observe_capacity=(recorder.capacity
                              if recorder is not None else 0),
            # hosts sample on the telemetry cadence; 0 keeps host-side
            # registries (and stats frames) compiled out entirely
            metrics_interval_s=(metrics.interval_s
                                if metrics is not None else 0.0),
            device=str(self.device))
        try:
            # all start-ups at once; then each joins as add_host's would
            for handle in self.manager.spawn_hosts(hosts):
                self._join_host(handle)
        except Exception:
            self.manager.shutdown()
            raise
        # collapse the construction ramp into one t=0 sample, like the
        # in-process ctor (RunReport pool integrals start at full strength)
        self.pool_log = [(0.0, len(self.workers))]

    # -- membership (whole hosts) ------------------------------------------
    def add_host(self) -> str:
        """Spawn one host process, replicate the store to it, register its
        ``threads_per_host`` executors.  Spawn messages go on the wire
        BEFORE the dispatcher learns each eid, so a racing pump can never
        dispatch to an executor the host hasn't spawned yet (per-host
        streams are ordered)."""
        handle = self.manager.spawn_host()
        self._join_host(handle)
        return handle.host_id

    def _join_host(self, handle: HostHandle) -> None:
        """Replicate the store to a connected host, register its executors
        and pump (the body of :meth:`add_host` after the spawn)."""
        for obj, payload in self.store.items():
            handle.send({"t": "put", "oid": obj.oid, "size": obj.size_bytes,
                         "payload": payload})
        for _ in range(self.threads_per_host):
            with self._lock:
                wid = self._next_worker_id
                self._next_worker_id += 1
            eid = f"w{wid}"
            handle.send({"t": "spawn", "eid": eid,
                         "cap": self._cap,
                         "policy": self._cpol.value,
                         "seed": self._seed + wid})
            with self._lock:
                self.workers[eid] = _RemoteExecutor(eid, handle, self)
                handle.eids.append(eid)
                self.dispatcher.executor_joined(eid, time.monotonic())
                self.pool_log.append((time.monotonic() - self._t0,
                                      len(self.workers)))
        if self.local_dispatch:
            # every host needs routes to every executor so locally-built
            # hints can resolve to cross-host peer fetches
            with self._lock:
                routes = {eid: [w.host.peer_host, w.host.peer_port]
                          for eid, w in self.workers.items()
                          if isinstance(w, _RemoteExecutor)}
            self.manager.broadcast({"t": "peers", "routes": routes})
        self._pump()

    def remove_host(self, host_id: str) -> None:
        """Graceful release (DRP shrink): deregister every executor, then
        shut the process down.  In-flight work (there should be none for a
        released-idle host, but the path is shared with tests) re-queues
        through executor_left like any removal."""
        with self._lock:
            handle = self.manager.handles.get(host_id)
            if handle is None or handle.dead:
                return
            handle.dead = True
            self._drop_host_locked(handle, failed=False)
        self.manager.reap(handle, graceful=True)
        if self.local_dispatch:
            self.manager.broadcast({"t": "index_drop", "eids": handle.eids})
        self._pump()

    def _drop_host_locked(self, handle: HostHandle, failed: bool) -> None:
        for eid in handle.eids:
            if self.workers.pop(eid, None) is None:
                continue
            self.pool_log.append((time.monotonic() - self._t0,
                                  len(self.workers)))
            self._deregister_locked(eid, failed)
        # unclaimed leases return to the queue front in lease order; any
        # claim frame still in flight from this host will be rejected (the
        # handle is dead) and its eventual done dropped by the membership
        # guard, so the re-queued task runs exactly once
        leased = self._leases.pop(handle.host_id, None)
        if leased:
            self.dispatcher.requeue_leased(leased.values())
        # fold the dying connection's wire counters into the runtime's
        # stats so dispatch_stats() keeps counting retired hosts (dead
        # handles are excluded from the live fold)
        self.stats.frames_sent += handle.frames_sent
        self.stats.msgs_sent += handle.msgs_sent
        self.stats.frames_recv += handle.frames_recv
        self.stats.msgs_recv += handle.msgs_recv

    def _on_host_dead(self, handle: HostHandle) -> None:
        """Receiver-EOF / monitor callback: requeue the dead host's
        in-flight tasks and drop its index entries.  Idempotent -- the
        ``dead`` flag flips under the runtime lock exactly once."""
        with self._lock:
            if handle.dead:
                return
            handle.dead = True
            self._drop_host_locked(handle, failed=True)
        self.manager.reap(handle)
        if self.local_dispatch:
            # surviving replicas must forget the dead executors' entries
            # (a late resurrection there costs a failed peer fetch, not
            # correctness, but the drop keeps local scores honest)
            self.manager.broadcast({"t": "index_drop", "eids": handle.eids})
        self._pump()

    def add_executor(self) -> str:
        raise RuntimeError("a fleet grows by whole hosts; use add_host()")

    def remove_executor(self, eid: str, failed: bool = False) -> None:
        raise RuntimeError("a fleet shrinks by whole hosts; use "
                           "remove_host() or manager.kill_host()")

    def configure_caches(self, capacity_bytes: int,
                         policy: EvictionPolicy) -> None:
        raise RuntimeError("fleet executor caches are fixed at host spawn")

    # -- provisioning hooks (whole-host granularity) ------------------------
    def provision_grow(self, n: int) -> None:
        for _ in range(n // self.threads_per_host):
            self.add_host()

    def provision_release(self, eids: Iterable[str]) -> None:
        by_host: dict[str, set[str]] = {}
        for eid in eids:
            w = self.workers.get(eid)
            if isinstance(w, _RemoteExecutor):
                by_host.setdefault(w.host.host_id, set()).add(eid)
        for host_id, group in by_host.items():
            handle = self.manager.handles.get(host_id)
            if handle is not None and set(handle.eids) <= group:
                self.remove_host(host_id)

    def provision_idle(self, now: float, idle_for_s: float) -> list[str]:
        """Only whole-idle hosts are offered (grouped host-by-host, so a
        quantum-truncated prefix still maps to whole hosts)."""
        idle = set(self.dispatcher.idle_executors(now, idle_for_s))
        out: list[str] = []
        for handle in self.manager.live_handles():
            if handle.eids and set(handle.eids) <= idle:
                out.extend(handle.eids)
        return out

    # -- data ---------------------------------------------------------------
    def put_object(self, obj: DataObject, payload: Any) -> None:
        super().put_object(obj, payload)
        # the store's own payload (a numpy array is kept as a CPU tensor)
        self.manager.broadcast({"t": "put", "oid": obj.oid,
                                "size": obj.size_bytes,
                                "payload": self.store.get(obj.oid)[1]})

    # -- central dispatch loop (batched wire) --------------------------------
    def _pump(self) -> None:
        """Fleet pump: one lock pass collects dispatches, lease grants and
        forwarded index updates; outside the lock everything is grouped per
        host and shipped as bounded batch frames (wire_batch=1 degenerates
        to the one-frame-per-message wire)."""
        with self._lock:
            t0 = time.perf_counter()
            now = time.monotonic()
            dispatches = self.dispatcher.next_dispatches(now)
            # leases engage only on backlog: a non-empty queue after
            # next_dispatches means no executor is idle, so under
            # batch-synchronous replay (B <= pool drains each chunk in one
            # pump against an all-idle pool) leases NEVER engage and
            # placement stays bit-identical to central dispatch
            lease_out = (self._lease_locked(now)
                         if self.local_dispatch else [])
            fwd, self._fwd_buf = self._fwd_buf, []
            self._note_pump_locked(len(dispatches), time.perf_counter() - t0)
        per_host: dict[str, tuple[HostHandle, list]] = {}
        if fwd:
            for handle in self.manager.live_handles():
                per_host[handle.host_id] = (
                    handle, [{"t": "index", "updates": fwd}])
        orphans = []
        for d in dispatches:
            w = self.workers.get(d.executor)
            if w is None:
                orphans.append(d)
            elif isinstance(w, _RemoteExecutor):
                ent = per_host.get(w.host.host_id)
                if ent is None:
                    ent = per_host[w.host.host_id] = (w.host, [])
                ent[1].append(w.task_msg(d))
            else:   # pragma: no cover - fleets hold only remote executors
                w.dispatch(d)
        for handle, msg in lease_out:
            ent = per_host.get(handle.host_id)
            if ent is None:
                ent = per_host[handle.host_id] = (handle, [])
            ent[1].append(msg)
        for handle, msgs in per_host.values():
            handle.send_batch(msgs, self.wire_batch)
        for d in orphans:
            with self._lock:
                self.dispatcher.task_finished(d.task, time.monotonic(),
                                              ok=False)

    def _lease_locked(self, now: float) -> list[tuple[HostHandle, list]]:
        """Top up each live host's lease pool from the queue head (up to
        ``lease_depth * threads_per_host`` outstanding per host); returns
        the per-host lease messages to ship."""
        if not self.dispatcher.queue:
            return []
        out: list[tuple[HostHandle, list]] = []
        sizes = self.dispatcher.sizes
        cap = self.lease_depth * self.threads_per_host
        for handle in self.manager.live_handles():
            pool = self._leases.setdefault(handle.host_id, {})
            granted = []
            while len(pool) < cap:
                t = self.dispatcher.lease_next()
                if t is None:
                    break
                pool[t.tid] = t
                self.stats.leases += 1
                if self.metrics is not None:
                    self.metrics.inc("wire.leases")
                granted.append({
                    "tid": t.tid,
                    "inputs": [[oid, sizes.get(oid, 0)] for oid in t.inputs],
                    "outputs": [[ob.oid, ob.size_bytes]
                                for ob in t.outputs]})
            if granted:
                out.append((handle, {"t": "lease", "tasks": granted}))
            if not self.dispatcher.queue:
                break
        return out

    def _on_update_locked(self, upd) -> None:
        super()._on_update_locked(upd)
        if self.local_dispatch:
            # queue the applied update for forwarding to host replicas on
            # the next pump (hosts apply them loosely-coherently, exactly
            # like the central index itself)
            self._fwd_buf.append([upd.executor, list(upd.added),
                                  list(upd.removed)])

    # -- update-channel consumers (called by the per-host receivers) --------
    def _on_remote_batch(self, handle: HostHandle, msgs: list) -> None:
        """Apply one frame's messages in wire order under ONE lock
        acquisition, then pump once if anything completed -- the receive-
        side half of the batching win (the send side cut the frame count;
        this cuts lock acquisitions and pump passes per completion storm)."""
        need_pump = False
        with self._lock:
            for msg in msgs:
                kind = msg["t"]
                if kind == "updates":
                    self._remote_update_locked(handle, msg)
                elif kind == "done":
                    self._remote_done_locked(handle, msg)
                    need_pump = True
                elif kind == "claim":
                    self._remote_claim_locked(handle, msg)
                elif kind == "stats":
                    # latest-wins per-host snapshot; the ClusterView has
                    # its own leaf lock and never calls out, so updating
                    # it under the runtime lock cannot deadlock
                    self.manager.cluster.update(msg["host"], msg)
                elif kind == "events" and self.recorder is not None:
                    # host-recorded lifecycle events ingest in wire order
                    # (the host enqueued them just before the done they
                    # describe, so exec events land before the central's
                    # own task_done).  The recorder has its own lock and
                    # never calls out, so taking it here cannot deadlock.
                    self.recorder.ingest(msg["events"])
                # hb riding in a batch already refreshed handle.last_hb
        if need_pump:
            self._pump()

    def _on_remote_updates(self, handle: HostHandle, msg: dict) -> None:
        self._on_remote_batch(handle, [msg])

    def _on_remote_done(self, handle: HostHandle, msg: dict) -> None:
        self._on_remote_batch(handle, [msg])

    def _remote_update_locked(self, handle: HostHandle, msg: dict) -> None:
        w = self.workers.get(msg["eid"])
        if not isinstance(w, _RemoteExecutor) or w.host is not handle:
            # the host was declared dead (or the executor deregistered)
            # while frames were still in flight: its index entries were
            # dropped with it, and a late update must not resurrect
            # locations for an executor that can never rejoin
            return
        self._on_update_locked(IndexUpdate(msg["eid"],
                                           added=tuple(msg["added"]),
                                           removed=tuple(msg["removed"])))

    def _remote_done_locked(self, handle: HostHandle, msg: dict) -> None:
        t = self.dispatcher.tasks.get(msg["tid"])
        w = self.workers.get(msg["eid"])
        if t is None or w is None:
            return   # executor already deregistered; executor_left ruled
        acc = _InputLedger(**msg["ledger"])
        if not msg["ok"]:
            t.result = RuntimeError(msg.get("error") or "remote failure")
        if t.start_time == 0.0:
            # results/payloads stay host-side; the central clock brackets
            # the attempt at dispatch..completion for the report's makespan
            t.start_time = t.dispatch_time
        self._finish_attempt_locked(w, t, acc, msg["ok"])

    def _remote_claim_locked(self, handle: HostHandle, msg: dict) -> None:
        """Reconcile a host's local claim against its lease pool.  Every
        conflict path falls back to central authority: the lease was
        already reclaimed (host declared dead mid-flight) or the claiming
        executor is no longer a member -- in both cases the claim is
        refused here and the attempt's eventual done is dropped by the
        membership guard, while the re-queued task runs centrally."""
        w = self.workers.get(msg["eid"])
        if (handle.dead or not isinstance(w, _RemoteExecutor)
                or w.host is not handle):
            self.stats.claim_conflicts += 1
            if self.metrics is not None:
                self.metrics.inc("wire.claim_conflicts")
            return
        pool = self._leases.get(handle.host_id)
        t = pool.pop(msg["tid"], None) if pool else None
        if t is None:
            self.stats.claim_conflicts += 1
            if self.metrics is not None:
                self.metrics.inc("wire.claim_conflicts")
            return
        self.dispatcher.bind_claim(t, msg["eid"], time.monotonic())
        self.stats.claims += 1
        if self.metrics is not None:
            self.metrics.inc("wire.claims")

    def sample_metrics(self) -> None:
        """On a fleet the per-host stats frames own the bandwidth totals
        (each host accumulates its own done-frame ledgers), so the
        inherited ledger-derived ``bw.*`` gauges are cleared after the base
        refresh -- folding central + hosts must not count bytes twice."""
        super().sample_metrics()
        m = self.metrics
        if m is None:
            return
        m.gauge_set("bw.bytes_local", 0)
        m.gauge_set("bw.bytes_c2c", 0)
        m.gauge_set("bw.bytes_store", 0)

    def request_stats(self, timeout: float = 2.0) -> dict:
        """Stats barrier: broadcast ``stats_req`` and wait until every live
        host's snapshot sequence advances past its pre-request reading --
        every returned snapshot is then a post-request sample.  Hosts that
        die mid-barrier stop being waited on.  Returns the cluster's
        per-host view (`ClusterView.per_host`)."""
        cv = self.manager.cluster
        before = cv.seqs()
        waiting = {h.host_id for h in self.manager.live_handles()}
        self.manager.broadcast({"t": "stats_req"})
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            seqs = cv.seqs()
            live = {h.host_id for h in self.manager.live_handles()}
            if all(seqs.get(h, 0) > before.get(h, 0)
                   for h in waiting & live):
                break
            time.sleep(0.005)
        return cv.per_host()

    def dispatch_stats(self) -> dict:
        """Central counters plus the wire counters of live connections
        (retired hosts were folded into ``stats`` at drop time).

        The live-handle snapshot is taken UNDER the runtime lock: the
        ``dead`` flag flips and the counter fold (`_drop_host_locked`)
        happen under this same lock, so a host retiring concurrently is
        counted exactly once.  (Snapshotting before acquiring the lock --
        the old shape -- let a host die in the gap and be counted twice:
        once from the stale live list, once from the folded stats.)
        Lock order runtime._lock -> manager._lock is safe; the manager
        never calls back into the runtime while holding its own lock."""
        with self._lock:
            d = self._stats_dict_locked()
            for h in self.manager.live_handles():
                d["frames_sent"] += h.frames_sent
                d["msgs_sent"] += h.msgs_sent
                d["frames_recv"] += h.frames_recv
                d["msgs_recv"] += h.msgs_recv
        return d

    # -- lifecycle ----------------------------------------------------------
    def shutdown(self) -> None:
        self._stop_pacing.set()
        self.manager.shutdown()
        self._close_recording()


#: single-process vs fleet: the RunReport fields that must agree exactly
#: when the same trace is replayed batch-synchronously on both (wall-clock
#: fields are excluded by construction; identity fields by definition).
SCHEDULING_DETERMINED_FIELDS = (
    "n_tasks", "n_completed", "n_failed",
    "local_hits", "peer_hits", "store_reads",
    "local_hit_ratio", "cache_hit_ratio",
    "mean_inputs_per_task", "full_hit_tasks", "partial_hit_tasks",
    "zero_hit_tasks", "bytes_by_kind",
    "peak_executors", "low_executors",
)


def reports_scheduling_equal(a, b) -> dict:
    """Diff two RunReports on the scheduling-determined fields only;
    empty dict == exact agreement (the fleet parity contract)."""
    out = {}
    for f in SCHEDULING_DETERMINED_FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        if va != vb:
            out[f] = (va, vb)
    return out


def fleet_task(payloads: dict) -> int:
    """A tiny, importable default task fn (``repro_torch.fleet.runtime:
    fleet_task``): sums every payload's byte length (a tensor's
    ``nbytes``, a bytes object's ``len``)."""
    total = 0
    for v in payloads.values():
        total += getattr(v, "nbytes", None) or (len(v) if hasattr(v, "__len__") else 0)
    return total


def slow_task(payloads: dict) -> int:
    """`fleet_task` plus a few ms of dwell -- keeps attempts in flight long
    enough for failure-injection tests to catch them mid-execution."""
    import time as _time

    _time.sleep(0.005)
    return fleet_task(payloads)


#: simulated per-node local-I/O bandwidth for `io_dwell_task` (bytes/s);
#: the paper testbed's single-node disk read rate, halved -- a slower
#: simulated disk makes runs sleep-dominated, so a measured scaling curve
#: survives a host's CPU-share throttling.  ``REPRO_BENCH_DISK_BW``
#: overrides it (inherited by spawned hosts, so a run can deepen dwell
#: without shipping proportionally larger payloads).
BENCH_DISK_BW = float(os.environ.get("REPRO_BENCH_DISK_BW") or 16 * 10**6)


def io_dwell_task(payloads: dict) -> int:
    """Service time = input bytes / BENCH_DISK_BW, slept on the executor
    thread.  This reproduces the paper's execution model -- a task's cost
    is dominated by its node-local I/O -- so a run's aggregate delivered
    bandwidth is bounded by how many *nodes* serve concurrently (the claim
    under test), not by the host's core count; what the fleet layer
    adds or loses on top (dispatch RPCs, wire codec, peer sockets) is
    exactly the overhead the wall clock then exposes."""
    import time as _time

    n = fleet_task(payloads)
    _time.sleep(n / BENCH_DISK_BW)
    return n
