"""Fleet host process: N executor threads + a peer-fetch server.

One host = one OS process (its own GIL -- the whole point) running:

  * a dispatch loop: framed messages from the central process, in order
    (``put`` store replicas, ``spawn``/``stop`` executors, ``task``
    dispatches routed to the executor's local channel, ``shutdown``);
  * ``threads_per_host`` executor threads, each an exact structural twin
    of `repro_torch.core.runtime.ExecutorWorker`: ExecutorCache + payload
    dict + dispatch Channel, resolving inputs local-cache -> hinted peers
    (in hint order; peers on this host are an in-process peek that shares
    the cached tensor, peers on other hosts a socket fetch) -> store
    replica, then running the task fn and caching outputs.  Index updates
    stream upstream *before* the attempt's ``done`` (the Channel seam
    ordering contract);
  * a peer server: other hosts fetch cached payloads from a specific
    executor here (the paper's GridFTP-analogue cache-to-cache path);
  * a heartbeat thread.

In central mode the host holds NO scheduling state: placement, hints,
retries, membership and all metrics stay in the central Dispatcher/
LocationIndex stack.  With ``local_dispatch`` (DESIGN.md §9) the host
additionally keeps a loosely-coherent `ShardedIndex` *replica* (fed by
``index`` frames the central forwards) plus a leased slice of the wait
queue: idle executors score leased tasks against the replica, claim the
best match upstream, and run it -- the central Dispatcher stays the only
authority (it reconciles every claim; unclaimed leases of a dead host
re-queue centrally).  Task callables cannot cross the wire; hosts resolve
``task_fn_name`` against the :data:`TASK_FNS` registry at startup
(shape-only tasks need none).

The store "replica" stands in for the paper's shared filesystem (GPFS):
equally reachable from every node, so each host holds a local copy seeded
by ``put`` broadcasts and store reads never touch the central process.

The device: every host runs on the one ``device`` the central resolved
(``FleetRuntime(device=...)``, default ``"cuda"``).  Its executor caches
hold tensors there and every task input is handed over there, as in the
in-process runtime: the store replica holds host (CPU) tensors, so a store
read is one host-to-device copy; a peer on another host costs a
device-to-host copy in the serving process, the socket, and a
host-to-device copy here.  A host that cannot get the device raises before
it connects, so its spawn fails (the manager reports the exit) -- it never
carries on on the CPU.  Every executor thread launches on the default
stream of the process, so a tensor a peer server reads is finished.
"""
from __future__ import annotations

import socket
import threading
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.core.cache import EvictionPolicy
from repro_torch.core.channel import BatchingChannel, ChannelClosed
from repro_torch.core.index import ShardedIndex
from repro_torch.core.objects import DataObject
from repro_torch.core.runtime import (SHAPE_ONLY_PAYLOAD, CacheExecutorBase,
                                      _wants_kwargs, on_device)
from repro_torch.device import resolve_device

from .wire import SocketChannel, recv_msg, send_msg

#: named task callables a host may run (callables don't serialise; a fleet
#: run names one and every host resolves it here).  Keyed registration so
#: tests and benchmarks can install fns before spawning hosts -- the
#: registry is module-level, so under the "spawn" start method the child
#: re-imports this module and the fn must be registered at import time of
#: whatever module ``register_task_fn`` was called from... which a fresh
#: interpreter will NOT replay.  Hosts therefore resolve names via
#: :func:`resolve_task_fn`, which also accepts dotted ``module:attr`` paths
#: importable in the child.
TASK_FNS: dict[str, Callable[..., Any]] = {}


def register_task_fn(name: str, fn: Callable[..., Any]) -> None:
    TASK_FNS[name] = fn


def resolve_task_fn(name: Optional[str]) -> Optional[Callable[..., Any]]:
    """None -> shape-only; registry name -> that fn; ``module:attr`` ->
    imported (works across process boundaries, unlike the registry)."""
    if name is None:
        return None
    if name in TASK_FNS:
        return TASK_FNS[name]
    if ":" in name:
        import importlib

        mod, _, attr = name.partition(":")
        fn = getattr(importlib.import_module(mod), attr)
        register_task_fn(name, fn)
        return fn
    raise KeyError(f"task fn {name!r} not registered on this host "
                   f"(register_task_fn at import time, or use module:attr)")


# --------------------------------------------------------------------------
# peer fetch (host <-> host data plane)
# --------------------------------------------------------------------------

class PeerClient:
    """Pooled framed connections to other hosts' peer servers."""

    def __init__(self, codec: str) -> None:
        self.codec = codec
        self._conns: dict[tuple[str, int], tuple[socket.socket, threading.Lock]] = {}
        self._lock = threading.Lock()
        self.bytes_fetched = 0

    def _conn(self, addr: tuple[str, int]) -> tuple[socket.socket, threading.Lock]:
        with self._lock:
            ent = self._conns.get(addr)
            if ent is None:
                s = socket.create_connection(addr, timeout=10.0)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                ent = (s, threading.Lock())
                self._conns[addr] = ent
            return ent

    def fetch(self, addr: tuple[str, int], eid: str, oid: str) -> Optional[Any]:
        """One fetch round-trip; any failure is a miss (hint staleness and
        dead peers cost performance, never correctness)."""
        try:
            sock, lock = self._conn(addr)
            with lock:
                send_msg(sock, {"t": "fetch", "eid": eid, "oid": oid},
                         self.codec)
                resp = recv_msg(sock, self.codec, timeout=30.0)
        except Exception:  # noqa: BLE001 - degrade to a store read
            with self._lock:
                ent = self._conns.pop(addr, None)
            if ent is not None:   # close, don't leak, the broken socket
                try:
                    ent[0].close()
                except OSError:
                    pass
            return None
        if not resp.get("ok"):
            return None
        return resp["payload"]

    def close(self) -> None:
        with self._lock:
            for s, _ in self._conns.values():
                try:
                    s.close()
                except OSError:
                    pass
            self._conns.clear()


class PeerServer(threading.Thread):
    """Serves this host's executor caches to other hosts."""

    def __init__(self, host: "FleetHost", codec: str,
                 bind_host: str = "127.0.0.1") -> None:
        super().__init__(daemon=True, name="peer-server")
        self.host = host
        self.codec = codec
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((bind_host, 0))
        self.sock.listen(16)
        self.port = self.sock.getsockname()[1]
        self._stop = threading.Event()

    def run(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve, args=(conn,), daemon=True,
                             name="peer-conn").start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            while True:
                req = recv_msg(conn, self.codec)
                ex = self.host.executors.get(req["eid"])
                payload = ex.cache_peek(req["oid"]) if ex is not None else None
                send_msg(conn, {"ok": payload is not None,
                                "payload": payload}, self.codec)
        except Exception:  # noqa: BLE001 - client went away
            try:
                conn.close()
            except OSError:
                pass

    def stop(self) -> None:
        self._stop.set()
        try:
            self.sock.close()
        except OSError:
            pass


# --------------------------------------------------------------------------
# executor threads (structural twins of ExecutorWorker)
# --------------------------------------------------------------------------

class HostExecutor(CacheExecutorBase):
    """One executor thread on a host: the shared cache/inbox surface from
    `repro_torch.core.runtime.CacheExecutorBase` (one implementation, so
    host and in-process cache semantics cannot drift apart) plus the
    host-side execute/resolve loop.  Its cache holds tensors on the host's
    device."""

    def __init__(self, eid: str, host: "FleetHost", cache_capacity: int,
                 policy: EvictionPolicy, seed: int) -> None:
        super().__init__(eid, cache_capacity, policy, seed, host.device)
        self.host = host
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name=f"executor-{eid}")

    def start(self) -> None:
        self.thread.start()

    # -- task loop ----------------------------------------------------------
    def _run(self) -> None:
        # announce readiness before blocking on the inbox: under
        # local_dispatch an idle executor is what pulls leased work
        self.host.executor_ready(self)
        while self.alive:
            try:
                msg = self.inbox.recv()
            except ChannelClosed:
                return
            self._execute(msg)
            self.host.executor_ready(self)

    def _admit(self, obj: DataObject, payload: Any) -> None:
        added, removed = self.cache_admit(obj, payload)
        self.host.send_update(self.eid, added, removed)

    def _resolve(self, oid: str, size: int, hints: dict[str, list],
                 routes: dict[str, list], led: dict[str, int],
                 tid: str = "") -> Any:
        """Mirror of DiffusionRuntime._resolve: local cache -> hinted peers
        in hint order (local peek for same-host executors, socket fetch for
        remote ones) -> store replica.  Accounting fields match
        core.runtime._InputLedger one-for-one.  The payload returned is on
        the host's device: a fetched or store-read host tensor is copied
        there once, and the cache keeps that copy."""
        rec = self.host.recorder
        payload = self.cache_lookup(oid)
        if payload is not None:
            led["cache_hits"] += 1
            led["bytes_local"] += size
            if rec is not None:
                rec.emit("input", tid=tid, eid=self.eid, oid=oid,
                         source="local", bytes=size)
            return payload
        led["cache_misses"] += 1
        for peer_id in hints.get(oid, ()):
            if peer_id == self.eid:
                continue
            local = self.host.executors.get(peer_id)
            if local is not None:
                payload = local.cache_peek(oid)
            elif peer_id in routes:
                h, p = routes[peer_id]
                payload = self.host.peers.fetch((h, int(p)), peer_id, oid)
            else:
                continue
            if payload is not None:
                led["peer_hits"] += 1
                led["bytes_cache_to_cache"] += size
                if rec is not None:
                    rec.emit("input", tid=tid, eid=self.eid, oid=oid,
                             source="peer", bytes=size, peer=peer_id)
                payload = on_device(payload, self.device)
                self._admit(DataObject(oid, size), payload)
                return payload
        ent = self.host.store.get(oid)
        if ent is None:
            raise KeyError(oid)   # matches the central store's KeyError
        obj, payload = ent
        led["bytes_store"] += obj.size_bytes
        if rec is not None:
            rec.emit("input", tid=tid, eid=self.eid, oid=oid,
                     source="store", bytes=obj.size_bytes)
        # the one host-to-device copy of a store read; the cache keeps this
        # same tensor (or refuses it, and then only this task uses it)
        payload = on_device(payload, self.device)
        self._admit(obj, payload)
        return payload

    def _execute(self, msg: dict) -> None:
        led = {"bytes_local": 0, "bytes_cache_to_cache": 0, "bytes_store": 0,
               "cache_hits": 0, "peer_hits": 0, "cache_misses": 0}
        hints = msg.get("hints") or {}
        routes = msg.get("routes") or {}
        rec = self.host.recorder
        tid = msg["tid"]
        ok, err, result = True, None, None
        try:
            inputs = {oid: self._resolve(oid, size, hints, routes, led,
                                         tid=tid)
                      for oid, size in msg["inputs"]}
            if rec is not None:
                rec.emit("exec_start", tid=tid, eid=self.eid)
            fn = self.host.task_fn
            if fn is not None:
                result = fn(**inputs) if _wants_kwargs(fn) else fn(inputs)
            for oid, osize in msg["outputs"]:
                # shape-only tasks: admit the wire-stable sentinel (mirrors
                # DiffusionRuntime._execute) so downstream DAG reads of the
                # produced object still count as cache hits
                if fn is None:
                    payload = SHAPE_ONLY_PAYLOAD
                else:
                    payload = result if len(msg["outputs"]) == 1 else result[oid]
                self._admit(DataObject(oid, int(osize)), payload)
        except Exception as e:  # noqa: BLE001 - task failure is data
            ok, err = False, f"{type(e).__name__}: {e}"
        if rec is not None:
            rec.emit("exec_end", tid=tid, eid=self.eid, ok=ok)
        self.host.send_done(self.eid, tid, ok, led, err)


# --------------------------------------------------------------------------
# the host process
# --------------------------------------------------------------------------

class FleetHost:
    def __init__(self, central: tuple[str, int], host_id: str, codec: str,
                 task_fn_name: Optional[str], hb_interval_s: float,
                 bind_host: str = "127.0.0.1", wire_batch: int = 64,
                 local_dispatch: bool = False,
                 observe_capacity: int = 0,
                 metrics_interval_s: float = 0.0,
                 device: str | torch.device = "cuda") -> None:
        self.host_id = host_id
        self.codec = codec
        # before anything connects: a host without the device fails here,
        # and its CUDA context is made now, not in its first task
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.zeros(1, device=self.device)
        self.task_fn = resolve_task_fn(task_fn_name)
        self.hb_interval_s = hb_interval_s
        self.bind_host = bind_host
        self.local_dispatch = local_dispatch
        # host-side event recording (DESIGN.md §10): same Recorder class as
        # the central, drained upstream with each done/heartbeat flush
        if observe_capacity > 0:
            from repro_torch.obs.recorder import Recorder

            self.recorder: Optional[Any] = Recorder(observe_capacity)
        else:
            self.recorder = None
        # host-side telemetry (DESIGN.md §13): an own registry, sampled on
        # the heartbeat cadence and shipped upstream as {"t": "stats"}
        # frames (0 = telemetry off, free -- no registry, no frames)
        self.metrics_interval_s = metrics_interval_s
        if metrics_interval_s > 0:
            from repro_torch.obs.metrics import MetricsRegistry

            self.metrics: Optional[Any] = MetricsRegistry()
        else:
            self.metrics = None
        self._last_stats = 0.0
        self._led_lock = threading.Lock()
        # cumulative attempt-ledger totals (absolute per-host gauges:
        # the cluster-wide value is the sum over hosts)
        self._led_totals = {"bytes_local": 0, "bytes_c2c": 0,
                            "bytes_store": 0, "tasks_done": 0}
        self.store: dict[str, tuple[DataObject, Any]] = {}
        self.executors: dict[str, HostExecutor] = {}
        self.peers = PeerClient(codec)
        self.peer_server = PeerServer(self, codec, bind_host)
        sock = socket.create_connection(central, timeout=30.0)
        # drop the connect timeout: it would otherwise persist on the
        # socket and turn any 30s dispatch lull into a phantom
        # central-death (blocking recv is the correct idle behaviour here)
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.up = SocketChannel(sock, codec)   # both directions of the pair
        # all upstream traffic funnels through one batcher so wire order
        # is exactly buffer order: an attempt's updates always precede its
        # done, and a claim always precedes its attempt's first update
        self.out = BatchingChannel(self.up, max_batch=wire_batch)
        self._stop = threading.Event()
        # -- local-dispatch state (DESIGN.md §9) ----------------------------
        self.replica = ShardedIndex()          # forwarded central index view
        self.routes: dict[str, list] = {}      # eid -> [peer_host, peer_port]
        self._sched_lock = threading.Lock()
        self._lease: list[dict] = []           # leased task descriptors
        self._idle: set[str] = set()           # eids waiting for lease work

    # -- upstream (the update channel of the pair) --------------------------
    def send_update(self, eid: str, added, removed) -> None:
        if self.local_dispatch:
            # short-circuit our own admissions into the replica: the central
            # forwards them back eventually, but fresher hints are free here
            # (re-application is idempotent -- the index is set-valued)
            self.replica.apply_wire([[eid, list(added), list(removed)]])
        try:
            # buffered: the matching done (flush=True) bounds the delay
            self.out.send({"t": "updates", "eid": eid,
                           "added": list(added), "removed": list(removed)})
        except ChannelClosed:
            self._stop.set()

    def send_done(self, eid: str, tid: str, ok: bool, led: dict,
                  err: Optional[str]) -> None:
        if self.metrics is not None:
            with self._led_lock:
                tot = self._led_totals
                tot["bytes_local"] += led["bytes_local"]
                tot["bytes_c2c"] += led["bytes_cache_to_cache"]
                tot["bytes_store"] += led["bytes_store"]
                tot["tasks_done"] += 1
        try:
            # drained events ride (buffered) immediately before the flushed
            # done: the attempt's input/exec events arrive in the frame that
            # carries its completion, and the updates-before-done ordering
            # is untouched because everything shares the one outbox buffer
            self._forward_events()
            self.out.send({"t": "done", "eid": eid, "tid": tid, "ok": ok,
                           "ledger": led, "error": err}, flush=True)
        except ChannelClosed:
            self._stop.set()

    def _forward_events(self) -> None:
        """Drain the host recorder into one buffered ``events`` message.
        A no-op with recording off; holds no host scheduling lock (the
        recorder has its own), so it can never reorder the outbox."""
        if self.recorder is None:
            return
        events = self.recorder.drain()
        if events:
            self.out.send({"t": "events", "host": self.host_id,
                           "events": events})

    def _sample_and_send(self, flush: bool = False) -> None:
        """Refresh this host's gauges and ship one ``stats`` frame through
        the shared outbox.  Cache counters are read without the executor
        locks -- racy int reads are fine for telemetry (the final, settled
        sample is exact because the executors are quiescent by then)."""
        m = self.metrics
        if m is None:
            return
        caches = [ex.cache for ex in list(self.executors.values())]
        m.gauge_set("cache.bytes", sum(c.used_bytes for c in caches))
        m.gauge_set("cache.hits", sum(c.stats.hits for c in caches))
        m.gauge_set("cache.misses", sum(c.stats.misses for c in caches))
        m.gauge_set("cache.evictions", sum(c.stats.evictions for c in caches))
        m.gauge_set("cache.insertions",
                    sum(c.stats.insertions for c in caches))
        m.gauge_set("cache.readmits", sum(c.stats.readmits for c in caches))
        with self._led_lock:
            tot = dict(self._led_totals)
        m.gauge_set("bw.bytes_local", tot["bytes_local"])
        m.gauge_set("bw.bytes_c2c", tot["bytes_c2c"])
        m.gauge_set("bw.bytes_store", tot["bytes_store"])
        m.gauge_set("host.tasks_done", tot["tasks_done"])
        m.gauge_set("host.executors", len(caches))
        _device_gauges(m, self.device)
        if self.recorder is not None:
            m.gauge_set("obs.recorder_dropped", self.recorder.dropped)
        self._last_stats = time.monotonic()
        try:
            # same outbox as updates/done: a stats frame sent after a done
            # reflects at least that attempt's ledger (ordering contract)
            self.out.send({"t": "stats", "host": self.host_id,
                           "metrics": m.snapshot()}, flush=flush)
        except ChannelClosed:
            self._stop.set()

    def _heartbeat(self) -> None:
        while not self._stop.wait(self.hb_interval_s):
            try:
                # flushing here bounds buffered-update staleness to one
                # heartbeat interval even on a host with no completions
                # (and bounds recorded-event staleness the same way)
                self._forward_events()
                if (self.metrics is not None
                        and time.monotonic() - self._last_stats
                        >= self.metrics_interval_s):
                    self._sample_and_send()   # buffered; hb flush carries it
                self.out.send({"t": "hb", "host_id": self.host_id},
                              flush=True)
            except ChannelClosed:
                return

    # -- local dispatch (lease pool -> idle executors) ----------------------
    def executor_ready(self, ex: HostExecutor) -> None:
        """Executor-thread callback on start and after every attempt: pull
        the best-matching leased task, or park in the idle set."""
        if not self.local_dispatch:
            return
        with self._sched_lock:
            if not ex.alive or not ex.inbox.empty():
                # centrally-dispatched work is already queued; run it first
                self._idle.discard(ex.eid)
                return
            ent = self._pick_locked(ex.eid)
            if ent is None:
                self._idle.add(ex.eid)
                return
            self._idle.discard(ex.eid)
            msg = self._task_msg(ex.eid, ent)
        # the claim goes upstream through the SAME outbox the attempt's
        # updates/done will use, BEFORE the task enters the inbox: wire
        # order therefore shows claim -> updates -> done, and the central
        # binds the lease before it can see the completion
        try:
            self.out.send({"t": "claim", "eid": ex.eid, "tid": msg["tid"]},
                          flush=True)
        except ChannelClosed:
            self._stop.set()
            return
        try:
            ex.inbox.send(msg)
        except ChannelClosed:
            pass

    def _pick_locked(self, eid: str) -> Optional[dict]:
        """Best lease-pool entry for ``eid`` by replica-cached input bytes
        (the host-local mirror of max-compute-util's byte score); ties break
        toward lease order.  Removes and returns the winner."""
        best_i, best_score = -1, -1
        for i, ent in enumerate(self._lease):
            score = 0
            for oid, size in ent["inputs"]:
                if eid in self.replica.lookup(oid):
                    score += int(size)
            if score > best_score:
                best_i, best_score = i, score
        if best_i < 0:
            return None
        return self._lease.pop(best_i)

    def _task_msg(self, eid: str, ent: dict) -> dict:
        hints: dict[str, list] = {}
        routes: dict[str, list] = {}
        for oid, _size in ent["inputs"]:
            locs = self.replica.lookup(oid)
            if locs:
                hints[oid] = sorted(locs)
                for peer in locs:
                    if peer not in self.executors and peer in self.routes:
                        routes[peer] = self.routes[peer]
        return {"t": "task", "eid": eid, "tid": ent["tid"],
                "inputs": ent["inputs"], "outputs": ent["outputs"],
                "hints": hints, "routes": routes}

    # -- dispatch loop ------------------------------------------------------
    def run(self) -> None:
        import os

        self.peer_server.start()
        self.up.send({"t": "hello", "host_id": self.host_id,
                      "pid": os.getpid(),
                      "peer_host": self.bind_host,
                      "peer_port": self.peer_server.port})
        threading.Thread(target=self._heartbeat, daemon=True,
                         name="heartbeat").start()
        try:
            while not self._stop.is_set():
                try:
                    msg = self.up.recv()
                except ChannelClosed:
                    break   # central went away: the fleet is over
                if not self._handle(msg):
                    break
        finally:
            self._stop.set()
            for ex in self.executors.values():
                ex.stop()
            self.peer_server.stop()
            self.peers.close()
            try:
                self._sample_and_send()  # settled final stats frame
                self._forward_events()   # last events ride the final flush
                self.out.close()   # flush buffered updates, then close up
            except ChannelClosed:
                self.up.close()

    def _handle(self, msg: dict) -> bool:
        kind = msg["t"]
        if kind == "batch":
            for m in msg["msgs"]:
                if not self._handle(m):
                    return False
        elif kind == "task":
            ex = self.executors.get(msg["eid"])
            if ex is not None:
                if self.local_dispatch:
                    with self._sched_lock:
                        self._idle.discard(msg["eid"])
                try:
                    ex.inbox.send(msg)
                except ChannelClosed:
                    pass
        elif kind == "lease":
            with self._sched_lock:
                self._lease.extend(msg["tasks"])
                ready = [self.executors[eid] for eid in sorted(self._idle)
                         if eid in self.executors]
            for ex in ready:
                self.executor_ready(ex)
        elif kind == "index":
            self.replica.apply_wire(msg["updates"])
        elif kind == "index_drop":
            for eid in msg["eids"]:
                self.replica.drop_executor(eid)
                self.routes.pop(eid, None)
        elif kind == "peers":
            self.routes.update(msg["routes"])
        elif kind == "stats_req":
            # the central's stats barrier (request_stats): answer with an
            # immediate, flushed sample
            self._sample_and_send(flush=True)
        elif kind == "put":
            obj = DataObject(msg["oid"], int(msg["size"]))
            self.store[obj.oid] = (obj, msg["payload"])
        elif kind == "spawn":
            ex = HostExecutor(msg["eid"], self, int(msg["cap"]),
                              EvictionPolicy(msg["policy"]), int(msg["seed"]))
            self.executors[msg["eid"]] = ex
            ex.start()
        elif kind == "stop":
            ex = self.executors.pop(msg["eid"], None)
            if ex is not None:
                ex.stop()
        elif kind == "shutdown":
            return False
        return True


def _device_gauges(m, device: torch.device) -> None:
    """The process's own device gauges on a card: what its kernel wrappers
    launched (each counter that has launched at all) and the memory its
    caching allocator holds.  On the CPU there are none, so a host's stats
    frame there carries exactly the reference's gauges."""
    if device.type != "cuda":
        return
    from repro_torch.kernels.build import COUNTERS

    for name, counter in COUNTERS.items():
        if counter.value:
            m.gauge_set(f"kernel.{name}.launches", counter.value)
    m.gauge_set("device.memory_allocated",
                torch.cuda.memory_allocated(device))
    m.gauge_set("device.memory_reserved", torch.cuda.memory_reserved(device))


def host_main(central_host: str, central_port: int, host_id: str,
              codec: str = "auto", task_fn_name: Optional[str] = None,
              hb_interval_s: float = 0.25, bind_host: str = "127.0.0.1",
              wire_batch: int = 64, local_dispatch: bool = False,
              observe_capacity: int = 0,
              metrics_interval_s: float = 0.0,
              device: str = "cuda") -> None:
    """Entry point for the spawned host process (see manager.py)."""
    FleetHost((central_host, central_port), host_id, codec,
              task_fn_name, hb_interval_s, bind_host=bind_host,
              wire_batch=wire_batch, local_dispatch=local_dispatch,
              observe_capacity=observe_capacity,
              metrics_interval_s=metrics_interval_s, device=device).run()
